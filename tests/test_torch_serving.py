"""The port's pipelined serving (rgrg_tpu_torch/serving.py) against the JAX
package's (rgrg_tpu/serving.py), report for report, on the CPU.

One module fixture: the JAX RGRG weights (shallow (1,1,1,1) backbone, 32
proposals, tiny decoder scaled x8 so sentences differ, then snapped onto
their int8 grid so the weight-int8 layouts quantize losslessly) carried
across to the port, and four 1024x768 uint8 X-rays, each the first seeded
image whose detector decisions and whose decoded rows' greedy and beam-3
decisions clear the two libraries' f32 disagreement (tests/torch_parity.py).
At this exact 2x downscale both packages' device resize give the same
pixels. The cascade runs on buckets (4, 12) up to max_length 12.

Cases: the serving defaults (greedy, int8 KV cache, speculation, cascade),
the parameter-dtype cache, beam 3 through the cascade, speculation off,
caller-selected regions, weights_int8 True and "pallas", a forced
budget miss (initial_budget=8 below the first batch's selection), and the
cascade bail-out; the CascadeStats snapshots must be equal too.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.core.config import GenerationConfig as JGenerationConfig
from rgrg_tpu.inference import ReportGenerator as JReportGenerator
from rgrg_tpu.models.full_model import RGRG as JRGRG
from rgrg_tpu.serving import CascadeStats as JCascadeStats
from rgrg_tpu.serving import generate_reports_pipelined as j_pipelined
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer

from rgrg_tpu_torch.core.config import GenerationConfig
from rgrg_tpu_torch.core.convert import from_jax_params
from rgrg_tpu_torch.inference import ReportGenerator
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.serving import CascadeStats, generate_reports_pipelined
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

from tests.test_torch_pipeline import SHAPE, configs
from tests.test_weights_int8 import _snap_to_int8_grid
from tests.torch_parity import beam_score_margin, greedy_logit_margin, has_parity_margins

BUCKETS = (4, 12)
MAX_LEN = 12
MIN_GAP = 1e-4
OVERRIDE = [0, 3, 7]  # regions of the selection_override case


def _override(n):
    sel = np.zeros((n, 29), bool)
    sel[:, OVERRIDE] = True
    return sel


def _no_eos(decoder, eos):
    """The decoder with its EOS embedding row zeroed: the tied LM head's
    EOS logit is then exactly 0 while the others are noise, so greedy rows
    never finish inside a bucket (zero rung-1 closure)."""
    dec = dict(decoder)
    dec["wte"] = {"embedding": jnp.asarray(decoder["wte"]["embedding"]).at[eos].set(0.0)}
    return dec


def _rows_have_margins(dec, feats, cfg):
    return (greedy_logit_margin(dec, feats, cfg, MAX_LEN) >= MIN_GAP
            and all(beam_score_margin(dec, feats, cfg, cap, 3, True) >= MIN_GAP
                    for cap in (BUCKETS[0], MAX_LEN)))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jcfg = dataclasses.replace(jcfg, generation=JGenerationConfig(length_buckets=BUCKETS))
    tcfg = dataclasses.replace(tcfg, generation=GenerationConfig(length_buckets=BUCKETS))
    # one jitted init compiles in a third of the time of the op-by-op one
    jp = jax.jit(JRGRG(jcfg).init)(jax.random.PRNGKey(0))
    jp = {"detector": jp["detector"],
          "decoder": _snap_to_int8_grid(jax.tree.map(lambda a: a * 8.0, jp["decoder"]))}
    jp_no_eos = {"detector": jp["detector"],
                 "decoder": _no_eos(jp["decoder"], jcfg.decoder.eos_token_id)}
    tp, tp_no_eos = (from_jax_params(jax.tree.map(np.asarray, p), tcfg, "cpu")
                     for p in (jp, jp_no_eos))
    gen = ReportGenerator(tp, GPT2Tokenizer.dummy(), cfg=tcfg)
    model = RGRG(tcfg)
    images = []
    for seed in range(64):
        image = np.random.default_rng([5, seed]).integers(0, 256, SHAPE, dtype=np.uint8)
        x = gen.preprocess([image])
        if not has_parity_margins(tp["detector"], x):
            continue
        det = model.detect(tp, x)
        rows = det["selected_regions"][0].clone()
        rows[OVERRIDE] = True
        feats = det["region_features"][0][rows]
        if (_rows_have_margins(tp["decoder"], feats, tcfg.decoder)
                and greedy_logit_margin(tp_no_eos["decoder"], feats, tcfg.decoder,
                                        MAX_LEN) >= MIN_GAP):
            images.append(image)
            if len(images) == 4:
                break
    else:
        raise AssertionError("not enough seeded images with decision margins")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jp_no_eos=jp_no_eos,
                tp_no_eos=tp_no_eos, images=images)


def _serve_both(setup, no_eos=False, **kw):
    """Both packages' pipelined reports and CascadeStats snapshots."""
    jp, tp = ((setup["jp_no_eos"], setup["tp_no_eos"]) if no_eos
              else (setup["jp"], setup["tp"]))
    jgen = JReportGenerator(jp, JTokenizer.dummy(), cfg=setup["jcfg"], similarity_fn=None)
    tgen = ReportGenerator(tp, GPT2Tokenizer.dummy(), cfg=setup["tcfg"])
    stats_kw = kw.pop("stats", {})
    jstats, tstats = JCascadeStats(**stats_kw), CascadeStats(**stats_kw)
    images = setup["images"] * kw.pop("repeat", 1)
    kw = {"batch_size": 2, "max_length": MAX_LEN, **kw}
    want = [r for c in j_pipelined(jgen, images, cascade_stats=jstats, **kw) for r in c]
    got = [r for c in generate_reports_pipelined(tgen, images, cascade_stats=tstats, **kw)
           for r in c]
    assert len(got) == len(want) == len(images)
    return got, want, tstats.snapshot(), jstats.snapshot()


def _same_reports(got, want):
    for g, w in zip(got, want):
        assert g.report == w.report
        assert g.region_sentences == w.region_sentences
        np.testing.assert_array_equal(g.selected_regions, np.asarray(w.selected_regions))
        np.testing.assert_array_equal(g.class_detected, np.asarray(w.class_detected))
        np.testing.assert_allclose(g.top_region_boxes, np.asarray(w.top_region_boxes),
                                   rtol=1e-4, atol=1e-3)


CASES = {
    "defaults": {},
    "kv_param_dtype": {"kv_cache_dtype": None},
    "beam3_cascade": {"num_beams": 3},
    "synchronous": {"speculative_decode": False},
    "selection_override": {"selection_override": _override(4)},
    "weights_int8_xla": {"weights_int8": True},
    "weights_int8_pallas": {"weights_int8": "pallas"},
    # one batch of the four images twice: it selects more rows than the
    # ladder's smallest budget (8), so speculating at 8 misses
    "budget_miss": {"repeat": 2, "batch_size": 8, "initial_budget": 8},
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_identical_to_jax(setup, case):
    got, want, tsnap, jsnap = _serve_both(setup, **dict(CASES[case]))
    _same_reports(got, want)
    assert any(r.region_sentences for r in got)
    assert tsnap == jsnap
    rungs = tsnap["rows_entering_rung"]
    assert rungs.get(BUCKETS[0], 0) > 0  # the cascade ran
    if case in ("defaults", "beam3_cascade"):
        assert rungs.get(BUCKETS[1], 0) > 0  # ... and continued past its first rung
    if case == "budget_miss":
        assert sum(int(r.selected_regions.sum()) for r in got) > 8


def test_cascade_bailout_identical_to_jax(setup):
    """Zero rung-1 closure bails out after the first batch in both packages,
    with equal telemetry and reports."""
    got, want, tsnap, jsnap = _serve_both(setup, no_eos=True,
                                          stats={"threshold": 0.5, "min_rows": 1})
    _same_reports(got, want)
    assert tsnap == jsnap
    assert tsnap["bailed_out"] and tsnap["rung1_closure_rate"] == 0.0
    assert tsnap["batches"] == 1


def test_pipelined_matches_direct(setup):
    gen = ReportGenerator(setup["tp"], GPT2Tokenizer.dummy(), cfg=setup["tcfg"])
    direct = gen.generate_reports(setup["images"], num_beams=1, max_length=MAX_LEN)
    piped = [r for c in generate_reports_pipelined(gen, setup["images"], batch_size=3,
                                                   max_length=MAX_LEN, kv_cache_dtype=None)
             for r in c]
    assert len(piped) == len(direct) == 4
    for a, b in zip(piped, direct):
        assert a.report == b.report and a.region_sentences == b.region_sentences
        np.testing.assert_array_equal(a.selected_regions, b.selected_regions)


def test_pipelined_empty_and_kv_cache_dtype_spellings(setup):
    gen = ReportGenerator(setup["tp"], GPT2Tokenizer.dummy(), cfg=setup["tcfg"])
    assert list(generate_reports_pipelined(gen, [], batch_size=2)) == []
    kw = dict(batch_size=2, max_length=6)
    images = setup["images"][:2]
    base = [r.report for c in generate_reports_pipelined(gen, images, kv_cache_dtype="int8",
                                                         **kw) for r in c]
    for spelling in (torch.int8, np.dtype("int8")):
        assert base == [r.report for c in generate_reports_pipelined(
            gen, images, kv_cache_dtype=spelling, **kw) for r in c]
    assert len([r for c in generate_reports_pipelined(
        gen, images, kv_cache_dtype=torch.bfloat16, **kw) for r in c]) == 2
    for bad in ("bf16", torch.int32, "float32"):
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            list(generate_reports_pipelined(gen, images, kv_cache_dtype=bad, **kw))
    with pytest.raises(ValueError, match="multiple"):
        list(generate_reports_pipelined(gen, images, batch_size=4, detect_image_chunk=3))

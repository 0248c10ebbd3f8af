"""The port's evaluation entry points against the JAX package, on the CPU.

One list of batch dicts built with numpy (the way tests/test_evaluator.py
builds them: normalised 512x512 images, random gt boxes, reference phrases
and reports) goes through both packages' `evaluate_model`, greedy and
beam 4 with early stopping, at max_length 8 over a bucket ladder (4, 8), so
the cascade runs two rungs (the beam run with a CascadeStats that bails
out after its first batch). The scores (detector, region selection and
abnormal, sentence and report NLG, CE through a deterministic labeler)
must be equal within 1e-6 and the text artifacts byte for byte;
`language_generation` must have the same keys and cascade counters (its
timings are not compared). `evaluate_bbox_variations` gives the same
{std: METEOR}. On the CPU the port runs the plain versions of K1-K3.

Model: the pipeline tests' shallow detector (tests/test_torch_pipeline.py
configs) with TINY_DEC's 2-layer decoder, JAX-initialised once (jitted)
and carried across by core/convert.py; decoder weights x8, so that
sentences differ and end with EOS. The tokenizer decodes the decoder's 50
ids to words, so NLG scores are not trivially 0. The batches are the first
seeded ones whose every detector, greedy and beam decision clears the two
libraries' f32 disagreement (tests/torch_parity.py).
"""

import dataclasses
import math
import sys

import numpy as np
import jax
import pytest
import torch

from rgrg_tpu.eval import artifacts as ja
from rgrg_tpu.eval.evaluator import (evaluate_bbox_variations as j_bbox,
                                     evaluate_model as j_evaluate, perturb_boxes as j_perturb)
from rgrg_tpu.models.full_model import RGRG as JRGRG
from rgrg_tpu.serving import CascadeStats as JCascadeStats
from rgrg_tpu.text.tokenizer import ENDOFTEXT, GPT2Tokenizer as JTokenizer

from rgrg_tpu_torch import evaluate as cli
from rgrg_tpu_torch.core.convert import from_jax_params
from rgrg_tpu_torch.eval.evaluator import (BinaryMetrics, DetectorMetrics,
                                           evaluate_bbox_variations, evaluate_model,
                                           perturb_boxes)
from rgrg_tpu_torch.inference import ReportGenerator
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.ops.beam_attn import beam_attention
from rgrg_tpu_torch.ops.nms import nms_keep_mask
from rgrg_tpu_torch.ops.roi_align import roi_align
from rgrg_tpu_torch.serving import CascadeStats
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer, _bytes_to_unicode

from tests.test_ops import random_boxes
from tests.test_torch_pipeline import configs
from tests.torch_parity import WORDS, eval_batches, greedy_logit_margin, image_with_margins

MAX_LEN = 8
NUM_BATCHES = 3         # of one image each, as tests/test_evaluator.py builds them
BUCKETS = (4,)          # the ladder (4, 8) at MAX_LEN 8
STDS = (0.0, 0.3)
TOL = 1e-6
MIN_GAP = 1e-4


def word_tokenizers():
    """(port, JAX) tokenizers whose first 50 ids (the decoder's vocabulary)
    are EOS and report words; the byte alphabet follows, so that any
    phrase encodes."""
    encoder = {ENDOFTEXT: 0}
    for w in WORDS:
        encoder["." if w == "." else "Ġ" + w] = len(encoder)
    for ch in sorted(set(_bytes_to_unicode().values()) - set(encoder)):
        encoder[ch] = len(encoder)
    return GPT2Tokenizer(encoder, []), JTokenizer(encoder, [])


def bbox_margins_ok(tp, cfg, batches):
    """Greedy decisions on the features pooled from evaluate_bbox_variations'
    perturbed boxes (its rng sequence)."""
    det = tp["detector"]
    for std in STDS:
        rng = np.random.default_rng(0)
        for batch in batches:
            boxes = perturb_boxes(batch["gt_boxes"], rng, "position", std)
            with torch.inference_mode():
                feats = det.region_features_from_boxes(
                    det.backbone(torch.from_numpy(batch["images"])), torch.from_numpy(boxes))
            valid = torch.from_numpy(batch["gt_valid"] & batch["region_has_sentence"])
            if greedy_logit_margin(tp["decoder"], feats[valid], cfg.decoder,
                                   MAX_LEN) < MIN_GAP:
                return False
    return True


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jcfg = dataclasses.replace(jcfg, generation=dataclasses.replace(
        jcfg.generation, length_buckets=BUCKETS))
    tcfg = dataclasses.replace(tcfg, generation=dataclasses.replace(
        tcfg.generation, length_buckets=BUCKETS))
    jp = jax.jit(JRGRG(jcfg).init)(jax.random.PRNGKey(0))
    jp = {"detector": jp["detector"],
          "decoder": jax.tree.map(lambda a: a * 8.0, jp["decoder"])}
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    batches = eval_batches([image_with_margins(tp, tcfg, slot, MAX_LEN, (BUCKETS[0], MAX_LEN),
                                               MIN_GAP) for slot in range(NUM_BATCHES)])
    assert bbox_margins_ok(tp, tcfg, batches)
    ttok, jtok = word_tokenizers()
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, batches=batches, ttok=ttok, jtok=jtok)


def fake_chexbert(reports):
    """A deterministic labeler: [14, N] labels 0..3 from each report's text."""
    return np.array([[(len(r) + 7 * j + r.count("e")) % (2 if j == 13 else 4)
                      for r in reports] for j in range(14)])


def lift_per_condition(scores):
    """`scores` with the CE conditions' blocks moved from "per_condition"
    up to the CE level, the nesting the JAX package's write_final_scores
    takes."""
    ce = dict(scores["report"]["CE"])
    return dict(scores, report=dict(scores["report"], CE={**ce.pop("per_condition"), **ce}))


def word_overlap(pairs):
    out = []
    for a, b in pairs:
        sa, sb = set(a.lower().split()), set(b.lower().split())
        out.append(len(sa & sb) / max(len(sa | sb), 1))
    return out


def assert_scores_close(got, want, path="scores"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_scores_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float):
        assert isinstance(got, float) and (math.isclose(got, want, rel_tol=0, abs_tol=TOL)
                                           or (math.isnan(got) and math.isnan(want))), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("num_beams", [1, 4])
def test_evaluate_model_identical_to_jax(setup, tmp_path, num_beams):
    s = setup
    kw = dict(num_beams=num_beams, max_length=MAX_LEN, similarity_fn=word_overlap,
              chexbert=fake_chexbert, num_figure_images=1, step=2)
    # beam: a CascadeStats that bails out after the first batch, so batch 2
    # decodes at max_length directly
    stats = ((JCascadeStats(threshold=1.1, min_rows=1), CascadeStats(threshold=1.1, min_rows=1))
             if num_beams > 1 else ("auto", "auto"))
    want = j_evaluate(JRGRG(s["jcfg"]), s["jp"], s["batches"], s["jtok"],
                      artifacts_dir=str(tmp_path / "jax"), cascade_stats=stats[0], **kw)
    kernels = (nms_keep_mask, roi_align, beam_attention)
    before = [k.launches for k in kernels]
    got = evaluate_model(RGRG(s["tcfg"]), s["tp"], s["batches"], s["ttok"],
                         artifacts_dir=str(tmp_path / "port"), cascade_stats=stats[1], **kw)
    # CPU tensors: K1-K3 ran their plain versions, no kernel launched
    assert [k.launches for k in kernels] == before
    lg, jlg = got.pop("language_generation"), want.pop("language_generation")
    assert lg.keys() == jlg.keys()
    assert lg["cascade"] == jlg["cascade"] and lg["language_images"] == jlg["language_images"]
    cascade = lg["cascade"]
    assert cascade["rows_entering_rung"].get(MAX_LEN, 0) > 0  # the second rung ran
    assert cascade["bailed_out"] == (num_beams > 1)
    assert_scores_close(got, want)
    assert want["sentence"]["meteor"] > 0 and "CE" in want["report"]
    assert want["object_detector"]["avg_detections_per_image"] > 0
    # artifacts: the text files byte for byte, the same figures
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                  if p.is_file()) == files
    assert sum(f.suffix == ".txt" for f in files) == 3 and any(f.suffix == ".png" for f in files)
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_nan_reference_report_fails_as_in_jax(setup):
    """An empty reference_report cell is NaN (truthy): both packages
    assemble its report and then fail to score it."""
    s = setup
    batch = dict(s["batches"][0], reference_reports=[float("nan"), "No effusion."])
    with pytest.raises(AttributeError) as want:
        j_evaluate(JRGRG(s["jcfg"]), s["jp"], [batch], s["jtok"], max_length=MAX_LEN,
                   similarity_fn=None)
    with pytest.raises(AttributeError) as got:
        evaluate_model(RGRG(s["tcfg"]), s["tp"], [batch], s["ttok"], max_length=MAX_LEN,
                       similarity_fn=None)
    assert str(got.value) == str(want.value)


def test_bbox_variations_identical_to_jax(setup):
    s = setup
    kw = dict(mode="position", stds=STDS, max_length=MAX_LEN)
    want = j_bbox(JRGRG(s["jcfg"]), s["jp"], s["batches"], s["jtok"], **kw)
    got = evaluate_bbox_variations(RGRG(s["tcfg"]), s["tp"], s["batches"], s["ttok"], **kw)
    assert got.keys() == want.keys() == set(STDS)
    for std in STDS:
        assert math.isclose(got[std], want[std], rel_tol=0, abs_tol=TOL), std
    assert max(want.values()) > 0


@pytest.mark.parametrize("mode", ["position", "scale", "aspect"])
def test_perturb_boxes_identical_to_jax(mode):
    boxes = np.stack([random_boxes(29, rng=np.random.default_rng(1)) for _ in range(3)])
    got = perturb_boxes(boxes, np.random.default_rng(4), mode, 0.4)
    want = j_perturb(boxes, np.random.default_rng(4), mode, 0.4)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        perturb_boxes(boxes, np.random.default_rng(4), "rotate", 0.4)


def test_metric_accumulators_identical_to_jax():
    from rgrg_tpu.eval.evaluator import BinaryMetrics as JB, DetectorMetrics as JD
    rng = np.random.default_rng(2)
    dm, jdm = DetectorMetrics(), JD()
    bm, jbm = BinaryMetrics(), JB()
    for _ in range(3):
        pred = np.stack([random_boxes(29, rng=rng) for _ in range(4)])
        gt = np.stack([random_boxes(29, rng=rng) for _ in range(4)])
        det, valid = rng.uniform(size=(2, 4, 29)) < 0.7
        for m in (dm, jdm):
            m.update(pred, det, gt, valid)
        p, t, mask = rng.uniform(size=(3, 4, 29)) < 0.5
        for m in (bm, jbm):
            m.update(p, t, mask)
    assert dm.compute() == jdm.compute() and bm.compute() == jbm.compute()


def test_evaluate_cli_split_loop_writes_final_scores(setup, tmp_path):
    """rgrg_tpu_torch/evaluate.py's split loop on a small model over a csv
    split (tests/test_torch_data.py's): the reference's final_scores
    layout, equal to evaluate_model run directly on the same batches."""
    from rgrg_tpu_torch.data.dataset import RGRGDataset, read_split_csv
    from tests.test_torch_data import write_split

    s = setup
    args = cli.build_parser().parse_args(["--checkpoint", "x.pt", "--tokenizer-dir", "t",
                                          "--test-csv", "a.csv"])
    assert (args.num_beams, args.max_length, args.max_language_batches, args.prefetch,
            args.batch_size, args.device) == (4, 300, 100, 2, 8, "cuda")
    split = write_split(tmp_path, shapes=[(700, 600)] * 4 + [(600, 700)] * 3,
                        name="test-2.csv", empty_report_row=None)
    gen = ReportGenerator(s["tp"], s["ttok"], cfg=s["tcfg"], similarity_fn=None)
    out_dir = tmp_path / "out"
    scores = cli.evaluate_splits(gen, [split], str(out_dir), batch_size=2, num_beams=1,
                                 max_length=MAX_LEN, num_figure_images=0, workers=2,
                                 chexbert=fake_chexbert)[split]
    body = (out_dir / "final_scores_test-2.txt").read_text()
    ja.write_final_scores(lift_per_condition(scores), str(tmp_path / "jax_layout.txt"))
    assert body == (tmp_path / "jax_layout.txt").read_text()
    lines = body.splitlines()
    assert lines[0].startswith("avg_num_detected_regions_per_image: ")
    assert all(len(line.split(": ")) == 2 and line.split(": ")[1].count(".") == 1
               for line in lines)
    assert any(line.startswith("report_CE_") for line in lines)
    # the same as evaluate_model on the dataset's batches, without prefetch
    ds = RGRGDataset(read_split_csv(split), s["ttok"])
    direct = evaluate_model(RGRG(s["tcfg"]), s["tp"], ds.batches(2), s["ttok"],
                            max_length=MAX_LEN, similarity_fn=None, chexbert=fake_chexbert)
    for k in ("object_detector", "region_selection", "report", "sentence"):
        assert scores.get(k) == direct.get(k), k
    assert (out_dir / "test-2" / "generated_sentences").is_dir() or "sentence" not in scores


def test_evaluate_cli_split_loop_raises_without_batches(setup, tmp_path, monkeypatch):
    """The split loop fails on a split that yields no batch (every image
    unreadable) and on a machine without cv2 (through the prefetch thread),
    and writes no final scores for it."""
    from tests.test_torch_data import write_split

    gen = ReportGenerator(setup["tp"], setup["ttok"], cfg=setup["tcfg"], similarity_fn=None)
    split = write_split(tmp_path, shapes=[(600, 500)] * 3, name="gone.csv",
                        empty_report_row=None)
    kw = dict(batch_size=2, num_beams=1, max_length=MAX_LEN, num_figure_images=0)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError):
            cli.evaluate_splits(gen, [split], str(tmp_path / "out"), **kw)
    for png in tmp_path.glob("img*.png"):
        png.unlink()
    with pytest.raises(ValueError, match="no batch"):
        cli.evaluate_splits(gen, [split], str(tmp_path / "out"), **kw)
    assert not (tmp_path / "out" / "final_scores_gone.txt").exists()

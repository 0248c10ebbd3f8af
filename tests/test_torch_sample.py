"""The port's sampling decode and the `no_image` (vanilla GPT-2) decode
against the JAX package, on the CPU.

Sampling: torch cannot replay `jax.random`, so the draws are never
compared. `_filter_logits` is held bit for bit against JAX's (top-k and
nucleus thresholds over logits with ties); the decode is pinned through
its deterministic cases (top_k=1 equals greedy, inactive rows, EOS / pad
bookkeeping and the early exit) and through `RGRG.decode_selected(
do_sample=True, top_k=1)` against JAX's on the same features.

no_image: prefill without features and the greedy step with slot 0
masked within 1e-5 of JAX's logits and caches (f32 sums in another
order); the beam step's t0=1 attention (kernel K3's plain version)
against JAX's -1e4 mask of slot 0, in f32 and with a bf16 cache; and
beam 4 token for token against transformers' `generate` on a random
2-layer GPT2LMHeadModel converted by the port's own convert_hf_gpt2_lm
(the model of tests/test_beam.py::test_beam_vs_modern_hf_generate).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.core import config as JC
from rgrg_tpu.decode.sample import _filter_logits as j_filter
from rgrg_tpu.models import gpt2 as jg
from rgrg_tpu.models.full_model import RGRG as JRGRG

from rgrg_tpu_torch.core import config as TC
from rgrg_tpu_torch.core.convert import decoder_from_jax
from rgrg_tpu_torch.core.torch_convert import convert_hf_gpt2_lm, state_dict_to_numpy
from rgrg_tpu_torch.decode.beam import beam_generate
from rgrg_tpu_torch.decode.greedy import greedy_generate
from rgrg_tpu_torch.decode.sample import _filter_logits, sample_generate
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.models.full_model import RGRG

from tests.test_gpt2 import TINY as J_TINY
from tests.torch_parity import greedy_logit_margin

CPU = torch.device("cpu")
TINY = TC.DecoderConfig(**{f.name: getattr(J_TINY, f.name)
                           for f in dataclasses.fields(TC.DecoderConfig)})
TOL = dict(rtol=1e-5, atol=1e-5)   # f32 logits and caches, summed in another order
MAX_LEN = 10


@pytest.fixture(scope="module")
def weights():
    jp = jg.init_decoder_params(jax.random.PRNGKey(1), J_TINY)
    return jp, decoder_from_jax(jax.tree.map(np.asarray, jp), CPU)


@pytest.fixture(scope="module")
def feats(weights):
    """Region features whose greedy path clears every top-1 / top-2 logit
    gap by 1e-4 (so top_k=1 has one finite logit per row, and the two
    libraries take the same argmax)."""
    _, tp = weights
    for seed in range(16):
        f = np.random.default_rng(seed).normal(0, 2, (6, J_TINY.image_feature_dim))
        f = f.astype(np.float32)
        if greedy_logit_margin(tp, torch.from_numpy(f), TINY, MAX_LEN) > 1e-4:
            return f
    raise AssertionError("no seeded input with greedy margins")


# ---------------------------------------------------------------- filtering

@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
def test_filter_logits_identical_to_jax(top_k, top_p):
    """Logits on a grid of halves, so rows hold many ties, including at the
    k-th value and at the nucleus threshold: the same entries are kept and
    the kept ones are unchanged."""
    rng = np.random.default_rng(top_k * 10 + int(top_p * 10))
    logits = (np.round(rng.normal(0, 2, (8, 40)) * 2) / 2).astype(np.float32)
    logits[0] = 1.0                     # one row of all-equal logits
    got = _filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    want = np.asarray(j_filter(jnp.asarray(logits), top_k, top_p))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).sum(axis=1).min() >= 1


# ------------------------------------------------------------------ decode

def test_top_k1_equals_greedy(weights, feats):
    _, tp = weights
    f = torch.from_numpy(feats)
    want = greedy_generate(tp, f, TINY, max_length=MAX_LEN)
    g = torch.Generator().manual_seed(2)
    got = sample_generate(tp, f, g, TINY, max_length=MAX_LEN, top_k=1, temperature=0.7)
    assert torch.equal(got, want)


def test_generators_vary_and_bos_is_fixed(weights, feats):
    _, tp = weights
    f = torch.from_numpy(feats)
    a = sample_generate(tp, f, torch.Generator().manual_seed(2), TINY,
                        max_length=MAX_LEN, temperature=2.0)
    b = sample_generate(tp, f, torch.Generator().manual_seed(3), TINY,
                        max_length=MAX_LEN, temperature=2.0)
    again = sample_generate(tp, f, torch.Generator().manual_seed(2), TINY,
                            max_length=MAX_LEN, temperature=2.0)
    assert (a != b).any() and torch.equal(a, again)
    assert (a[:, 0] == TINY.bos_token_id).all()


def test_active_rows_eos_bookkeeping_and_early_exit(weights):
    """Top-2 sampling with EOS moved to the token a free-running decode
    (no EOS) samples most often after its fourth token, pad kept at 0:
    rows finish at different steps; after a row's first EOS it holds pad;
    an inactive row is pad after BOS; the loop stops once every row has
    finished, before max_length; all rows inactive take no decode step."""
    _, tp = weights
    f = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (12, J_TINY.image_feature_dim)).astype(np.float32))
    pad, max_len = 0, 40
    free = sample_generate(tp, f, torch.Generator().manual_seed(0),
                           dataclasses.replace(TINY, eos_token_id=-1), max_length=max_len,
                           top_k=2).numpy()[:, 5:]
    vals, counts = np.unique(free[free != pad], return_counts=True)
    eos = int(vals[np.argmax(counts)])
    cfg = dataclasses.replace(TINY, eos_token_id=eos)
    active = torch.ones(12, dtype=torch.bool)
    active[3] = False
    before = sample_generate.steps
    out = sample_generate(tp, f, torch.Generator().manual_seed(0), cfg, max_length=max_len,
                          top_k=2, active=active).numpy()
    steps = sample_generate.steps - before
    assert (out[3, 1:] == pad).all()
    first = []
    for r in range(12):
        if r == 3:
            continue
        hit = np.flatnonzero(out[r, 1:] == eos)
        assert len(hit), r
        assert (out[r, 2 + hit[0]:] == pad).all()
        first.append(int(hit[0]))
    assert len(set(first)) > 1
    assert steps == max(first) < max_len - 2
    before = sample_generate.steps
    none = sample_generate(tp, f, torch.Generator().manual_seed(0), cfg, max_length=8,
                           active=torch.zeros(12, dtype=torch.bool)).numpy()
    assert sample_generate.steps == before
    assert (none[:, 0] == TINY.bos_token_id).all() and (none[:, 1:] == pad).all()


def _model_cfgs():
    dec = {f.name: getattr(J_TINY, f.name) for f in dataclasses.fields(TC.DecoderConfig)}
    return (JC.ModelConfig(decoder=JC.DecoderConfig(**dec)),
            TC.ModelConfig(decoder=TC.DecoderConfig(**dec)))


def test_decode_selected_sampling_top_k1_identical_to_jax_and_greedy(weights, feats):
    """decode_selected(do_sample=True, top_k=1) on 2 images x 29 regions
    with 6 selected: ids identical to JAX's (its own sampling key) and to
    the port's greedy decode_selected; unselected regions are pad."""
    jp, tp = weights
    jcfg, tcfg = _model_cfgs()
    region = np.zeros((2, 29, J_TINY.image_feature_dim), np.float32)
    sel = np.zeros((2, 29), bool)
    for i, (b, r) in enumerate([(0, 1), (0, 7), (0, 28), (1, 0), (1, 5), (1, 13)]):
        region[b, r] = feats[i]
        sel[b, r] = True
    kw = dict(r_budget=8, max_length=MAX_LEN)
    jids, jdec = JRGRG(jcfg).decode_selected({"decoder": jp}, jnp.asarray(region),
                                             jnp.asarray(sel), do_sample=True, top_k=1,
                                             sample_rng=jax.random.PRNGKey(7), **kw)
    model = RGRG(tcfg)
    ids, dec = model.decode_selected({"decoder": tp}, torch.from_numpy(region),
                                     torch.from_numpy(sel), do_sample=True, top_k=1,
                                     temperature=0.5,
                                     sample_generator=torch.Generator().manual_seed(7), **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    greedy, _ = model.decode_selected({"decoder": tp}, torch.from_numpy(region),
                                      torch.from_numpy(sel), **kw)
    assert torch.equal(ids, greedy)
    assert (ids.numpy()[~sel] == TINY.pad_token_id).all()


def test_return_done_with_sampling_raises(weights):
    _, tp = weights
    _, tcfg = _model_cfgs()
    region = torch.zeros(1, 29, J_TINY.image_feature_dim)
    sel = torch.zeros(1, 29, dtype=torch.bool)
    with pytest.raises(ValueError, match="beam-search signal"):
        RGRG(tcfg).decode_selected({"decoder": tp}, region, sel, 4, 6, num_beams=4,
                                   do_sample=True, return_done=True)


# ---------------------------------------------------------------- no_image

@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_prefill_and_decode_step_without_image_match_jax(weights, cache):
    """prefill(None, batch=5) then three decode_step(no_image=True): logits
    and caches (slot 0 zero) within 1e-5 of JAX's."""
    jp, tp = weights
    jdt, tdt = {"f32": (None, None), "int8": (jnp.int8, torch.int8)}[cache]
    jl, jc = jg.prefill(jp, None, J_TINY.bos_token_id, MAX_LEN, J_TINY, cache_dtype=jdt,
                        batch=5)
    tl, tc = gpt2.prefill(tp, None, TINY.bos_token_id, MAX_LEN, TINY, cache_dtype=tdt,
                          batch=5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert not tc["k"][:, :, :, 0].float().abs().any()
    rng = np.random.default_rng(4)
    for step in range(3):
        tok = rng.integers(0, J_TINY.vocab_size, 5)
        jl, jc = jg.decode_step(jp, jnp.asarray(tok, jnp.int32), jnp.int32(step), jc,
                                J_TINY, no_image=True)
        tl, tc = gpt2.decode_step(tp, torch.from_numpy(tok), step, tc, TINY, no_image=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {step}")
        for name in tc:
            np.testing.assert_allclose(tc[name].numpy().astype(np.float32),
                                       np.asarray(jc[name]).astype(np.float32), **TOL,
                                       err_msg=f"{name} step {step}")


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_beam_step_without_image_attends_from_slot_1_like_jax(weights, cache):
    """decode_step_beam(no_image=True), whose K3 call takes t0=1, against
    JAX's step, which masks slot 0 with -1e4, after a prefill without
    features: f32 logits within 1e-5; with a bf16 cache (zero slot 0 in
    bf16) both sides within 2e-2 of the f32 logits."""
    jp, tp = weights
    items, kb = 3, 4
    jdt, tdt = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}[cache]
    _, jc = jg.prefill(jp, None, J_TINY.bos_token_id, MAX_LEN, J_TINY, cache_dtype=jdt,
                       batch=items * kb)
    _, tc = gpt2.prefill(tp, None, TINY.bos_token_id, MAX_LEN, TINY, cache_dtype=tdt,
                         batch=items * kb)
    jc = jg.cache_to_beam_layers(jc, pack_pairs=False)
    tc = gpt2.cache_to_beam_layers(tc)
    rng = np.random.default_rng(6)
    tol = TOL if cache == "f32" else dict(rtol=2e-2, atol=2e-2)
    for step in range(3):
        tok = rng.integers(0, J_TINY.vocab_size, items * kb)
        anc = rng.integers(0, kb, (items, kb, MAX_LEN + 1)).astype(np.int32)
        jl, jc = jg.decode_step_beam(jp, jnp.asarray(tok, jnp.int32), jnp.int32(step), jc,
                                     jnp.asarray(anc), J_TINY, no_image=True)
        tl, tc = gpt2.decode_step_beam(tp, torch.from_numpy(tok), step, tc,
                                       torch.from_numpy(anc), TINY, no_image=True)
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), **tol,
                                   err_msg=f"step {step}")


def test_beam_without_image_matches_hf_generate():
    """beam_generate(None, no_image=True, batch=3), beam 4, against
    transformers' generate on the same random GPT-2, converted by the
    port's convert_hf_gpt2_lm: token for token on HF's window, pad after."""
    from transformers import GPT2Config, GPT2LMHeadModel
    hf_cfg = GPT2Config(vocab_size=61, n_positions=32, n_embd=32, n_layer=2, n_head=4,
                        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0,
                        eos_token_id=0, pad_token_id=0)
    torch.manual_seed(3)
    hf = GPT2LMHeadModel(hf_cfg).eval()
    tree = convert_hf_gpt2_lm(state_dict_to_numpy(hf.state_dict()), num_layers=2)
    params = decoder_from_jax(tree, CPU)
    assert not params["h_0"]["attn"]["uk"]["kernel"].any()
    cfg = TC.DecoderConfig(vocab_size=61, hidden_dim=32, num_heads=4, num_layers=2,
                           max_positions=32, positions_from_wte=False, bos_token_id=0,
                           eos_token_id=0, pad_token_id=0)
    max_length = 14
    with torch.no_grad():
        want = hf.generate(torch.zeros((3, 1), dtype=torch.long), max_length=max_length,
                           num_beams=4, do_sample=False, length_penalty=1.0,
                           early_stopping=False).numpy()
    got = beam_generate(params, None, cfg, max_length=max_length, num_beams=4,
                        no_image=True, batch=3).numpy()
    np.testing.assert_array_equal(got[:, :want.shape[1]], want)
    assert (got[:, want.shape[1]:] == 0).all()
    assert len({tuple(r) for r in got}) == 1   # no image: every row is the same text

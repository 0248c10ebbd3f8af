"""The port's GPT-2 decoder and greedy decode against the JAX package.

Same JAX-initialized weights (TINY config) carried across by
core/convert.py; inputs from numpy with a seed. Logits agree to 1e-5 (f32
matmuls summed in a different order by each library); greedy ids are
identical, with the f32 and the int8 KV cache, with and without the
`active` row mask.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.decode.greedy import greedy_generate as j_greedy
from rgrg_tpu.models import gpt2 as jg

from rgrg_tpu_torch.core.config import DecoderConfig
from rgrg_tpu_torch.core.convert import decoder_from_jax
from rgrg_tpu_torch.decode.greedy import greedy_generate
from rgrg_tpu_torch.models import gpt2

from tests.test_gpt2 import TINY as J_TINY

TINY = DecoderConfig(**{f.name: getattr(J_TINY, f.name)
                        for f in dataclasses.fields(DecoderConfig)})
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def weights():
    jp = jg.init_decoder_params(jax.random.PRNGKey(1), J_TINY)
    return jp, decoder_from_jax(jax.tree.map(np.asarray, jp), CPU)


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(1).normal(0, 1, (5, J_TINY.hidden_dim)).astype(np.float32)


def _cache_dtypes(name):
    return {"f32": (None, None), "int8": (jnp.int8, torch.int8)}[name]


def test_config_copy_matches_jax_defaults():
    from rgrg_tpu.core import config as JC
    from rgrg_tpu_torch.core import config as TC
    for port_cls, jax_cls in [(TC.DecoderConfig, JC.DecoderConfig),
                              (TC.RPNConfig, JC.RPNConfig),
                              (TC.RoIConfig, JC.RoIConfig),
                              (TC.AnchorConfig, JC.AnchorConfig),
                              (TC.GenerationConfig, JC.GenerationConfig),
                              (TC.ClassifierConfig, JC.ClassifierConfig)]:
        jdef = jax_cls()
        for f in dataclasses.fields(port_cls):
            assert getattr(port_cls(), f.name) == getattr(jdef, f.name), f.name


def test_init_decoder_params_tree_matches_jax():
    g = torch.Generator().manual_seed(0)
    tp = gpt2.init_decoder_params(g, TINY, torch.float32, CPU)
    jp = jg.init_decoder_params(jax.random.PRNGKey(0), J_TINY)
    jflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(jflat) == set(tflat)
    for k in jflat:
        assert tuple(tflat[k].shape) == jflat[k].shape, k
    # N(0, 0.02) weights from the generator, deterministic per seed
    tp2 = gpt2.init_decoder_params(torch.Generator().manual_seed(0), TINY)
    torch.testing.assert_close(tp["wte"]["embedding"], tp2["wte"]["embedding"])
    assert 0.01 < float(tp["wte"]["embedding"].std()) < 0.03


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(2).normal(0, 3, (2, 4, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero vector: scale floor 1e-8
    q, s = gpt2._quantize_kv(torch.from_numpy(x))
    jq, js = jg._quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_prefill_and_steps_match_jax(weights, feats, cache):
    jp, tp = weights
    jdt, tdt = _cache_dtypes(cache)
    max_len = 8
    jl, jc = jg.prefill(jp, jnp.asarray(feats), J_TINY.bos_token_id, max_len,
                        J_TINY, cache_dtype=jdt)
    tl, tc = gpt2.prefill(tp, torch.from_numpy(feats), TINY.bos_token_id,
                          max_len, TINY, cache_dtype=tdt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in jc:
        np.testing.assert_allclose(tc[name].numpy().astype(np.float32),
                                   np.asarray(jc[name]).astype(np.float32),
                                   **TOL, err_msg=name)

    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int64)
    for t in range(5):
        jl, jc = jg.decode_step(jp, jnp.asarray(tok, jnp.int32), jnp.int32(t), jc, J_TINY)
        tl, tc = gpt2.decode_step(tp, torch.from_numpy(tok), t, tc, TINY)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {t}")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int64)


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("with_active", [False, True], ids=["all", "active"])
def test_greedy_ids_identical_to_jax(weights, feats, cache, with_active):
    jp, tp = weights
    jdt, tdt = _cache_dtypes(cache)
    active = np.array([True, False, True, True, False]) if with_active else None
    want = np.asarray(j_greedy(jp, jnp.asarray(feats), J_TINY, max_length=12,
                               active=None if active is None else jnp.asarray(active),
                               cache_dtype=jdt))
    got = greedy_generate(tp, torch.from_numpy(feats), TINY, max_length=12,
                          active=None if active is None else torch.from_numpy(active),
                          cache_dtype=tdt).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == TINY.bos_token_id).all()
    if active is not None:
        assert (got[~active, 1:] == TINY.pad_token_id).all()


def test_greedy_eos_padding_and_early_exit_identical_to_jax(weights, feats):
    """Make the most frequently generated token EOS (and pad): rows finish
    at different steps, get pad after EOS, and the loop ends early once all
    rows are done; ids stay identical to JAX."""
    jp, tp = weights
    free = np.asarray(j_greedy(jp, jnp.asarray(feats), J_TINY, max_length=16))
    vals, counts = np.unique(free[:, 1:], return_counts=True)
    eos = int(vals[np.argmax(counts)])
    jcfg = dataclasses.replace(J_TINY, eos_token_id=eos, pad_token_id=eos)
    tcfg = dataclasses.replace(TINY, eos_token_id=eos, pad_token_id=eos)
    want = np.asarray(j_greedy(jp, jnp.asarray(feats), jcfg, max_length=16))
    got = greedy_generate(tp, torch.from_numpy(feats), tcfg, max_length=16).numpy()
    np.testing.assert_array_equal(got, want)
    finished = (got[:, 1:] == eos).any(axis=1)
    assert finished.any()
    for row in got[finished]:
        first = 1 + int(np.argmax(row[1:] == eos))
        assert (row[first:] == eos).all()

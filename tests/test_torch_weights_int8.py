"""Weight-only int8 decoder weights in the port against the JAX package.

- `quantize_decoder_weights` gives JAX's int8 grid and scales bit for bit,
  in both layouts, from f32 and bf16 weights.
- The plain version of kernel K4 (`ops/dense_wint8.dense_wint8` on the CPU)
  against JAX's `dense_wint8` (the Pallas kernel in interpret mode, or its
  XLA fallback for shapes that do not tile) on the shapes of
  tests/test_weights_int8.py, f32 and bf16 x, with and without bias.
  Tolerance as tests/test_torch_kernels.assert_wint8_close (f32: rtol 2e-5
  / atol 2e-4; bf16: one bf16 ulp plus the f32 summation-order drift).
- The "xla" layout in bf16 rounds the product to bf16 before the scale,
  as JAX's `_dense` does.
- Greedy and beam decode over both layouts are token-identical to JAX on
  inputs whose decisions clear the f32 noise (tests/torch_parity.py); with
  weights on their int8 grid they equal the unquantized decode.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.decode.beam import beam_generate as j_beam
from rgrg_tpu.decode.greedy import greedy_generate as j_greedy
from rgrg_tpu.models import gpt2 as jg
from rgrg_tpu.ops.dense_wint8_pallas import dense_wint8 as j_dense_wint8

from rgrg_tpu_torch.core.config import DecoderConfig
from rgrg_tpu_torch.core.convert import decoder_from_jax
from rgrg_tpu_torch.decode.beam import beam_generate
from rgrg_tpu_torch.decode.greedy import greedy_generate
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8

from tests.test_torch_kernels import assert_wint8_close, wint8_inputs
from tests.test_weights_int8 import _snap_to_int8_grid, _tiny_cfg
from tests.torch_parity import beam_score_margin, greedy_logit_margin

CPU = torch.device("cpu")
MAX_LEN = 12
MIN_GAP = 1e-4
LAYOUTS = ["xla", "pallas"]


def _port_cfg(jcfg):
    return DecoderConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(DecoderConfig)})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return decoder_from_jax(_np_tree(tree), CPU)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_quantize_bit_identical_to_jax(layout, dtype):
    jparams = jg.init_decoder_params(jax.random.PRNGKey(0), _tiny_cfg(), getattr(jnp, dtype))
    want = _np_tree(jg.quantize_decoder_weights(jparams, layout=layout))
    got = gpt2.quantize_decoder_weights(_torch_tree(jparams), layout=layout)
    kernel = "kernel_q" if layout == "pallas" else "kernel"
    for i in range(2):
        for grp, kn in (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
                        ("mlp", "c_proj")):
            g, w = got[f"h_{i}"][grp][kn], want[f"h_{i}"][grp][kn]
            assert set(g) == set(w) == {kernel, "scale", "bias"}
            assert g[kernel].dtype == torch.int8 and g["scale"].dtype == torch.float32
            np.testing.assert_array_equal(g[kernel].numpy(), w[kernel])
            np.testing.assert_array_equal(g["scale"].numpy(), w["scale"])
            np.testing.assert_array_equal(g["bias"].float().numpy(),
                                          np.asarray(w["bias"], np.float32))
        # the image adapters stay as they were
        np.testing.assert_array_equal(got[f"h_{i}"]["attn"]["uk"]["kernel"].float().numpy(),
                                      np.asarray(want[f"h_{i}"]["attn"]["uk"]["kernel"],
                                                 np.float32))
    with pytest.raises(ValueError, match="layout"):
        gpt2.quantize_decoder_weights(got, layout="int4")


SHAPES = [(16, 128, 512, ()), (8, 256, 1024, ()), (16, 128, 512, (4,)), (5, 96, 100, ())]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,lead", SHAPES,
                         ids=["tiled", "tiled_wide", "lead_dims", "ragged_fallback"])
def test_dense_wint8_plain_matches_jax(m, k, n, lead, dtype, bias):
    x, q, s, b = wint8_inputs(m, k, n, seed=m * k + n, lead=lead)
    tdt = getattr(torch, dtype)
    tx, tq, ts = torch.from_numpy(x).to(tdt), torch.from_numpy(q), torch.from_numpy(s)
    tb = torch.from_numpy(b).to(tdt) if bias else None
    got = dense_wint8(tx, tq, ts, tb)
    assert got.dtype == tdt and tuple(got.shape) == lead + (m, n)
    want = j_dense_wint8(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(q), jnp.asarray(s),
                         jnp.asarray(b, getattr(jnp, dtype)) if bias else None)
    want = torch.from_numpy(np.array(want, np.float32)).to(tdt)
    assert_wint8_close(tx, tq, ts, got, want)


def test_xla_layout_bf16_rounding_matches_jax():
    """bf16 through the "xla" layout: the product is rounded to bf16, then
    scaled and biased in f32 and rounded again (JAX's `_dense`), which is
    not what the "pallas" layout computes."""
    x, q, s, b = wint8_inputs(16, 256, 384, seed=3)
    p = {"kernel": q, "scale": s[0], "bias": b}
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "bias" else None) for k, v in p.items()}
    want = np.asarray(jg._dense(jnp.asarray(x, jnp.bfloat16), jp), np.float32)
    tp = {"kernel": torch.from_numpy(q), "scale": torch.from_numpy(s[0]),
          "bias": torch.from_numpy(b).to(torch.bfloat16)}
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = gpt2._dense(tx, tp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    pallas = dense_wint8(tx, tp["kernel"], tp["scale"], tp["bias"])
    assert not torch.equal(got, pallas)


def _feats(cfg, seed):
    return np.random.default_rng(seed).normal(0, 1, (6, cfg.image_feature_dim)).astype(
        np.float32)


def _margined_feats(tq, cfg, beams=2):
    for seed in range(32):
        feats = torch.from_numpy(_feats(cfg, seed))
        if (greedy_logit_margin(tq, feats, cfg, MAX_LEN) >= MIN_GAP
                and beam_score_margin(tq, feats, cfg, MAX_LEN, beams, False) >= MIN_GAP):
            return feats
    raise AssertionError("no seeded input with decision margins")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_over_quantized_layout_identical_to_jax(layout):
    jcfg = _tiny_cfg()
    cfg = _port_cfg(jcfg)
    jparams = jax.tree.map(lambda a: a * 4.0,
                           jg.init_decoder_params(jax.random.PRNGKey(1), jcfg))
    jq = jg.quantize_decoder_weights(jparams, layout=layout)
    tq = gpt2.quantize_decoder_weights(_torch_tree(jparams), layout=layout)
    feats = _margined_feats(tq, cfg)
    jf = jnp.asarray(feats.numpy())
    np.testing.assert_array_equal(greedy_generate(tq, feats, cfg, max_length=MAX_LEN).numpy(),
                                  np.asarray(j_greedy(jq, jf, jcfg, max_length=MAX_LEN)))
    np.testing.assert_array_equal(
        beam_generate(tq, feats, cfg, max_length=MAX_LEN, num_beams=2).numpy(),
        np.asarray(j_beam(jq, jf, jcfg, max_length=MAX_LEN, num_beams=2)))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_grid_exact_weights_decode_like_unquantized(layout):
    """Weights snapped onto their int8 grid quantize losslessly: decode
    over the quantized tree equals decode over the unquantized one."""
    jcfg = _tiny_cfg()
    cfg = _port_cfg(jcfg)
    snapped = _torch_tree(_snap_to_int8_grid(
        jax.tree.map(lambda a: a * 4.0, jg.init_decoder_params(jax.random.PRNGKey(5), jcfg))))
    tq = gpt2.quantize_decoder_weights(snapped, layout=layout)
    feats = _margined_feats(snapped, cfg)
    assert torch.equal(greedy_generate(tq, feats, cfg, max_length=MAX_LEN),
                       greedy_generate(snapped, feats, cfg, max_length=MAX_LEN))
    assert torch.equal(beam_generate(tq, feats, cfg, max_length=MAX_LEN, num_beams=2),
                       beam_generate(snapped, feats, cfg, max_length=MAX_LEN, num_beams=2))

"""Kernels K1 (csrc/nms.cu), K2 (csrc/roi_align.cu), K3
(csrc/beam_attn.cu) and K4 (csrc/dense_wint8.cu) against their plain
PyTorch versions, on the card.

These tests need an NVIDIA GPU and `nvcc`; they skip where
torch.cuda.is_available() is false. The file imports neither jax nor
tests/conftest.py's setup, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The input builders here are shared with tests/test_torch_ops.py, which holds
the plain versions against the JAX package on the CPU.
"""

import numpy as np
import pytest
import torch

from rgrg_tpu_torch.models.gpt2 import _quantize_kv
from rgrg_tpu_torch.ops.beam_attn import beam_attention, beam_attention_plain
from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8, dense_wint8_plain
from rgrg_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain
from rgrg_tpu_torch.ops.roi_align import roi_align, roi_align_plain


def random_boxes(n, extent=512.0, min_size=1.0, rng=None):
    x1 = rng.uniform(0, extent - min_size, n)
    y1 = rng.uniform(0, extent - min_size, n)
    w = rng.uniform(min_size, extent / 3, n)
    h = rng.uniform(min_size, extent / 3, n)
    x2 = np.minimum(x1 + w, extent)
    y2 = np.minimum(y1 + h, extent)
    return np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)


def _clustered(n, seed, extent=512.0):
    rng = np.random.default_rng(seed)
    base = random_boxes(max(n // 10, 4), extent=extent, rng=rng)
    jitter = rng.normal(0, 8, (n, 4)).astype(np.float32)
    b = np.clip(base[rng.integers(0, len(base), n)] + jitter, 0, extent)
    b[:, 2] = np.maximum(b[:, 2], b[:, 0] + 1)
    b[:, 3] = np.maximum(b[:, 3], b[:, 1] + 1)
    return b.astype(np.float32), rng


def nms_case(name):
    """(sorted boxes [N, 4] f32, valid [N] bool, threshold)."""
    if name == "n1000":
        b, _ = _clustered(1000, 0)
        return b, np.ones(1000, bool), 0.7
    if name == "n300_t05":
        b, _ = _clustered(300, 1)
        return b, np.ones(300, bool), 0.5
    if name == "ties_duplicates":
        # exact duplicates (IoU 1, equal scores as far as order goes) and
        # boxes whose IoU sits exactly on the threshold
        b, rng = _clustered(200, 2)
        b[50:60] = b[10]
        b[100] = [0, 0, 10, 10]
        b[101] = [0, 0, 10, 7]     # IoU with 100 on the threshold (0.7)
        b[102] = [0, 0, 10, 7.1]   # IoU with 100 just above it
        return b, np.ones(200, bool), 0.7
    if name == "zero_area_invalid":
        b, rng = _clustered(257, 3)
        b[5] = [30, 30, 30, 30]            # zero area: NaN IoU, never suppresses
        b[6] = [30, 30, 30, 30]
        b[7] = [30, 30, 40, 30]
        valid = rng.uniform(size=257) > 0.3
        valid[:4] = [True, False, True, False]
        b[1] = b[0]                        # invalid duplicate of a kept box
        return b, valid, 0.7
    if name == "all_invalid":
        b, _ = _clustered(130, 4)
        return b, np.zeros(130, bool), 0.7
    raise KeyError(name)


NMS_CASES = ["n1000", "n300_t05", "ties_duplicates", "zero_area_invalid",
             "all_invalid"]


def roi_boxes(n, rng):
    """Random boxes plus boxes that cross or lie outside the 512 map and
    sub-pixel / sub-cell boxes."""
    b = random_boxes(n - 8, extent=512.0, min_size=2.0, rng=rng)
    edge = np.array([
        [0.0, 0.0, 512.0, 512.0],
        [500.0, 500.0, 512.0, 512.0],
        [0.0, 0.0, 0.5, 0.5],
        [-40.0, -20.0, 100.0, 60.0],
        [480.0, 100.0, 700.0, 300.0],
        [530.0, 530.0, 600.0, 640.0],
        [-90.0, -90.0, -10.0, -5.0],
        [250.3, 250.1, 250.4, 250.2],
    ], np.float32)
    return np.concatenate([b, edge]).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_kernel_equals_plain(cuda, name):
    b, valid, thr = nms_case(name)
    tb = torch.from_numpy(np.stack([b, b[::-1].copy()])).to(cuda)
    tv = torch.from_numpy(np.stack([valid, valid[::-1].copy()])).to(cuda)
    before = nms_keep_mask.launches
    got = nms_keep_mask(tb, tv, thr)
    torch.cuda.synchronize()
    assert nms_keep_mask.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  nms_keep_mask_plain(tb, tv, thr).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_equals_plain(cuda, dtype):
    rng = np.random.default_rng(11)
    feats = torch.from_numpy(rng.normal(0, 1, (2, 16, 16, 2048)).astype(np.float32))
    feats = feats.to(cuda, dtype)
    bx = torch.from_numpy(np.stack([roi_boxes(100, rng), roi_boxes(100, rng)])).to(cuda)
    before = roi_align.launches
    got = roi_align(feats, bx)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    want = roi_align_plain(feats, bx)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("heads,dim,t0", [(16, 64, 0), (4, 16, 0), (2, 100, 1)],
                         ids=["gpt2_medium", "narrow", "wide_slot0_hidden"])
def test_beam_attention_kernel_equals_plain(cuda, kind, heads, dim, t0):
    """Both read the same stored values and compute in f32; they differ
    only in summation order and the softmax's running rescale (~1e-6)."""
    rng = np.random.default_rng(heads + dim)
    items, beams, t, slot = 6, 4, 13, 9
    bk = items * beams
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    q = torch.from_numpy(rng.normal(0, 1, (bk, heads, dim)).astype(np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.normal(0, 1, (heads, bk, t, dim)).astype(np.float32)).to(cuda)
            for _ in range(2))
    scales = {}
    if kind == "int8":
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        scales = {"k_scale": ks.contiguous(), "v_scale": vs.contiguous()}
    else:
        k, v = k.to(dtype), v.to(dtype)
    anc = torch.from_numpy(rng.integers(0, beams, (items, beams, t)).astype(np.int32)).to(cuda)
    before = beam_attention.launches
    got = beam_attention(q, k, v, anc, slot, scale=dim ** -0.5, t0=t0, **scales)
    torch.cuda.synchronize()
    assert beam_attention.launches == before + 1
    want = beam_attention_plain(q, k, v, anc, slot, scale=dim ** -0.5, t0=t0, **scales)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def wint8_inputs(m, k, n, seed=0, lead=()):
    """x [*lead, m, k] ~ N(0, 1) (a layer-normed activation), and q, scale
    [1, n] quantized per column from GPT-2-like weights ~ N(0, 0.02) as
    quantize_decoder_weights does, a bias ~ N(0, 0.1); all numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, lead + (m, k)).astype(np.float32)
    w = rng.normal(0, 0.02, (k, n)).astype(np.float32)
    s = np.maximum(np.abs(w).max(axis=0, keepdims=True) / np.float32(127), np.float32(1e-12))
    q = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    return x, q, s.astype(np.float32), b


def assert_wint8_close(x, q, scale, got, want):
    """f32: rtol 2e-5 / atol 2e-4 (summation order). bf16: within one bf16
    ulp of the plain output, plus the bound on how far two f32 summation
    orders of the same products can drift apart (2 K 2^-24 sum |x q| s),
    which only matters where the sum nearly cancels."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)
        return
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    k = q.shape[0]
    drift = (x.float().abs().reshape(-1, k) @ q.float().abs()).reshape(w.shape)
    drift = drift * scale.reshape(-1) * (2 * k * 2.0 ** -24)
    err = (got.float() - w).abs()
    assert bool((err <= ulp + drift).all()), float((err - ulp - drift).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(64, 1024, 3072), (64, 1024, 1024), (64, 1024, 4096),
                                   (64, 4096, 1024), (256, 1024, 3072), (256, 4096, 1024),
                                   (5, 96, 100), (37, 200, 48)],
                         ids=["c_attn64", "c_proj64", "c_fc64", "mlp_proj64", "c_attn256",
                              "mlp_proj256", "ragged", "ragged_k"])
def test_dense_wint8_kernel_equals_plain(cuda, dtype, m, k, n):
    x, q, s, b = wint8_inputs(m, k, n, seed=m + k + n)
    tx = torch.from_numpy(x).to(cuda, dtype)
    tq, ts = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    tb = torch.from_numpy(b).to(cuda, dtype)
    for bias in (tb, None):
        before = dense_wint8.launches
        got = dense_wint8(tx, tq, ts, bias)
        torch.cuda.synchronize()
        assert dense_wint8.launches == before + 1
        assert got.dtype == dtype and tuple(got.shape) == (m, n)
        assert_wint8_close(tx, tq, ts, got, dense_wint8_plain(tx, tq, ts, bias))
        # the split-K fixup leaves its counts zeroed: a second launch agrees
        assert torch.equal(dense_wint8(tx, tq, ts, bias), got)


@pytest.mark.cuda
def test_dense_wint8_kernel_leading_dims(cuda):
    x, q, s, b = wint8_inputs(16, 128, 512, seed=1, lead=(4,))
    tx = torch.from_numpy(x).to(cuda, torch.bfloat16)
    tq, ts = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    tb = torch.from_numpy(b).to(cuda, torch.bfloat16)
    got = dense_wint8(tx, tq, ts, tb)
    assert tuple(got.shape) == (4, 16, 512)
    assert_wint8_close(tx, tq, ts, got, dense_wint8_plain(tx, tq, ts, tb))

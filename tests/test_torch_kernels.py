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
from rgrg_tpu_torch.ops import beam_attn, kernels
from rgrg_tpu_torch.ops.beam_attn import beam_attention, beam_attention_plain
from rgrg_tpu_torch.ops.dense_wint8 import (BLOCK_K, MAX_SPLITS, dense_wint8,
                                            dense_wint8_plain, launch, plan)
from rgrg_tpu_torch.ops.nms import (nms_keep_mask, nms_keep_mask_plain,
                                    nms_suppression_words, nms_words)
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

# N around K1's 64-box groups, up to its limit, and images of four kinds
NMS_SIZES = [1, 63, 64, 65, 130, 2048]
NMS_KINDS = ["clustered", "all_invalid", "all_disjoint", "chain"]


def nms_edge_case(n, kind, seed=0):
    """(sorted boxes [n, 4] f32, valid [n] bool, threshold 0.7).
    "clustered": overlapping clusters, a fifth of the boxes invalid;
    "all_invalid": the same boxes, none valid; "all_disjoint": a grid of
    boxes that do not touch (all kept); "chain": boxes shifted 1.2 px each,
    so each suppresses the next (IoU 0.79) but not the one after (0.61):
    greedy keeps every other box."""
    if kind in ("clustered", "all_invalid"):
        b, rng = _clustered(n, 10 + seed)
        valid = rng.uniform(size=n) > 0.2 if kind == "clustered" else np.zeros(n, bool)
        return b, valid, 0.7
    i = np.arange(n, dtype=np.float32)
    if kind == "all_disjoint":
        x, y = (i % 46) * 20.0, (i // 46) * 20.0
        return np.stack([x, y, x + 10, y + 10], 1).astype(np.float32), np.ones(n, bool), 0.7
    if kind == "chain":
        x = i * 1.2
        return (np.stack([x, np.zeros(n), x + 10, np.full(n, 10.0)], 1).astype(np.float32),
                np.ones(n, bool), 0.7)
    raise KeyError(kind)


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


def sweep_boxes(n, rng):
    """Boxes of every kind a RoIAlign weight row can see, each axis drawn
    apart: corners inside, before (negative) and past the 512 map; sizes
    zero, negative (degenerate), sub-cell, ordinary, and wider than the map
    (bins over two cells: four taps)."""
    def axis():
        start = rng.uniform(-700, 1100, n)
        size = np.choose(rng.integers(0, 5, n), [
            np.zeros(n), rng.uniform(-60, 0, n), rng.uniform(0.01, 32, n),
            rng.uniform(32, 512, n), rng.uniform(512, 3000, n)])
        return start, start + size
    x1, x2 = axis()
    y1, y2 = axis()
    return np.stack([x1, y1, x2, y2], 1).astype(np.float32)


# chip_smoke.py's edge boxes, then boxes wider than the map (four taps a bin)
EDGE_BOXES = np.array([
    [0, 0, 512, 512], [500, 500, 512, 512], [0, 0, 0.5, 0.5], [-40, -20, 100, 60],
    [530, 530, 600, 640], [-90, -90, -10, -5]], np.float32)
WIDE_BOXES = np.array([[-300, -250, 900, 800], [-1000, 0, 1500, 512],
                       [0, -900, 512, 1400]], np.float32)


def roi_edge_boxes(n, rng):
    """n boxes: the wide ones first, then the edge ones, then a sweep."""
    fixed = np.concatenate([WIDE_BOXES, EDGE_BOXES])
    return np.concatenate([fixed, sweep_boxes(max(n - len(fixed), 0), rng)])[:n]


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
@pytest.mark.parametrize("kind", NMS_KINDS)
@pytest.mark.parametrize("n", NMS_SIZES)
def test_nms_kernel_sizes_equal_plain(cuda, n, kind):
    b, valid, thr = nms_edge_case(n, kind)
    tb, tv = torch.from_numpy(b)[None].to(cuda), torch.from_numpy(valid)[None].to(cuda)
    got = nms_keep_mask(tb, tv, thr)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  nms_keep_mask_plain(tb, tv, thr).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", NMS_SIZES)
def test_nms_kernel_batch8_equals_plain(cuda, n):
    cases = [nms_edge_case(n, kind, seed) for seed in range(2) for kind in NMS_KINDS]
    tb = torch.from_numpy(np.stack([c[0] for c in cases])).to(cuda)
    tv = torch.from_numpy(np.stack([c[1] for c in cases])).to(cuda)
    before = nms_keep_mask.launches
    got = nms_keep_mask(tb, tv, 0.7)
    torch.cuda.synchronize()
    assert nms_keep_mask.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  nms_keep_mask_plain(tb, tv, 0.7).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", NMS_SIZES)
def test_nms_words_kernel_equals_model(cuda, n):
    """K1's words step alone equals the plain bitmask model bit for bit."""
    cases = [nms_edge_case(n, kind) for kind in NMS_KINDS]
    tb = torch.from_numpy(np.stack([c[0] for c in cases])).to(cuda)
    got = nms_words(tb, 0.7)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_suppression_words(tb, 0.7))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 256])
@pytest.mark.parametrize("c", [4, 100, 102, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_shapes(cuda, dtype, c, n):
    """C 4, 100 and 2048 take the 4-channel route (100: a partial block),
    102 the one-channel route; N 1 is a box wider than the map (four taps
    a bin), 7 adds chip_smoke's edge boxes, 256 a sweep of every kind. A
    relaunch is bit-identical."""
    rng = np.random.default_rng(c + n)
    feats = torch.from_numpy(rng.normal(0, 1, (2, 16, 16, c)).astype(np.float32))
    feats = feats.to(cuda, dtype)
    bx = torch.from_numpy(np.stack([roi_edge_boxes(n, rng), roi_edge_boxes(n, rng)[::-1].copy()]))
    bx = bx.to(cuda)
    before = roi_align.launches
    got = roi_align(feats, bx)
    again = roi_align(feats, bx)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, roi_align_plain(feats, bx), rtol=1e-4, atol=1e-4)


def k3_ancestry(pattern, items, beams, t, slot, rng):
    """[items, beams, t] int32 ancestor beams. "random": any beam at any
    slot; "one_lane": every beam reads beam 0's lane (one row per slot);
    "distinct": each beam its own lane (K rows per slot); "grown": as beam
    search grows it, each step every beam picks a random parent of its item
    and owns the slot it writes, so beams share early history."""
    if pattern == "random":
        return rng.integers(0, beams, (items, beams, t)).astype(np.int32)
    if pattern == "one_lane":
        return np.zeros((items, beams, t), np.int32)
    anc = np.broadcast_to(np.arange(beams, dtype=np.int32)[None, :, None],
                          (items, beams, t)).copy()
    if pattern == "grown":
        for s in range(2, slot + 1):
            parent = rng.integers(0, beams, (items, beams))
            anc = np.take_along_axis(anc, parent[:, :, None], axis=1)
            anc[:, :, s] = np.arange(beams)
    return anc


def k3_inputs(cuda, kind, items, beams, heads, dim, t, slot, pattern, seed):
    """q, k, v ~ N(0, 1) in `kind` (int8: quantized as the decoder's cache,
    with its scales), an ancestry of `pattern`; all on the card."""
    rng = np.random.default_rng(seed)
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
    anc = torch.from_numpy(k3_ancestry(pattern, items, beams, t, slot, rng)).to(cuda)
    return q, k, v, anc, scales


# (heads, dim, t0, T, slot): the decoder's heads, narrow heads, 100 dims
# (rows of 200 bf16 / 100 int8 bytes take the element-wise copies) with
# slot 0 hidden, and a slot range longer than one staging chunk
K3_SHAPES = {"gpt2_medium": (16, 64, 0, 13, 9), "narrow": (4, 16, 0, 13, 9),
             "wide_slot0_hidden": (2, 100, 1, 13, 9), "long": (16, 64, 0, 61, 60)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", list(K3_SHAPES))
@pytest.mark.parametrize("pattern", ["random", "one_lane", "distinct", "grown"])
@pytest.mark.parametrize("beams", [2, 4])
def test_beam_attention_kernel_equals_plain(cuda, kind, shape, pattern, beams):
    """Both read the same stored values and compute in f32; they differ
    only in summation order and the softmax's running rescale (~1e-6)."""
    heads, dim, t0, t, slot = K3_SHAPES[shape]
    q, k, v, anc, scales = k3_inputs(cuda, kind, 24 // beams, beams, heads, dim, t, slot,
                                     pattern, seed=heads + dim)
    before = beam_attention.launches
    got = beam_attention(q, k, v, anc, slot, scale=dim ** -0.5, t0=t0, **scales)
    torch.cuda.synchronize()
    assert beam_attention.launches == before + 1
    want = beam_attention_plain(q, k, v, anc, slot, scale=dim ** -0.5, t0=t0, **scales)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("plan_", [(1, 1, 1), (3, 3, 5), (8, 2, 8), (4, 4, 16), (2, 2, 7),
                                   (5, 3, 9), (1, 16, 8), (8, 1, 32)],
                         ids=lambda p: "x".join(map(str, p)))
def test_beam_attention_kernel_every_plan(cuda, kind, plan_):
    """Forced plans (beams and heads a block, slots a chunk) over 12 beams
    of 2 items and 16 heads: beam and head groups that do not divide K and
    H, chunks of one slot and chunks that end mid-range, more shared memory
    than 48 KB."""
    beams, heads, slots = plan_
    q, k, v, anc, scales = k3_inputs(cuda, kind, 2, 12, 16, 64, 61, 47, "grown", seed=3)
    p = beam_attn.Plan(beams, heads, slots, 32 * beams * heads,
                       beam_attn.smem_bytes(k.dtype, 64, beams, heads, slots))
    out = torch.empty(q.shape, dtype=torch.float32, device=cuda)
    beam_attn.launch(q, k, v, anc, 47, 0.125, 2, scales.get("k_scale"), scales.get("v_scale"),
                     out, p)
    torch.cuda.synchronize()
    want = beam_attention_plain(q, k, v, anc, 47, scale=0.125, t0=2, **scales)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_beam_attention_kernel_relaunch_bit_identical(cuda, kind):
    q, k, v, anc, scales = k3_inputs(cuda, kind, 12, 4, 16, 64, 61, 59, "grown", seed=5)
    first = beam_attention(q, k, v, anc, 59, scale=0.125, **scales)
    second = beam_attention(q, k, v, anc, 59, scale=0.125, **scales)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_beam_attention_smem_matches_kernel(cuda):
    """The planner's shared-memory count equals the kernel's layout."""
    lib = kernels.library("beam_attn")
    for dtype, kind in ((torch.float32, 0), (torch.bfloat16, 1), (torch.int8, 2)):
        for d in (1, 16, 63, 64, 100, 128):
            for plan_ in ((1, 1, 1), (4, 1, 32), (8, 2, 32), (3, 5, 7)):
                assert (lib.rgrg_beam_attention_smem(kind, d, *plan_)
                        == beam_attn.smem_bytes(dtype, d, *plan_))


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
        # the cluster reduces split-K in a fixed order: a second launch is
        # bit-identical
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8])
def test_dense_wint8_kernel_every_cluster_size(cuda, dtype, splits):
    """K split over 1-8 blocks of one cluster (forced plans, the decoder's
    c_fc shape at 64 rows, and a ragged M that ends inside a rank's rows);
    each result within tolerance and bit-identical on a second launch."""
    for m, k, n in ((64, 1024, 4096), (45, 1024, 384)):
        x, q, s, b = wint8_inputs(m, k, n, seed=splits)
        tx = torch.from_numpy(x).to(cuda, dtype)
        tq, ts = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
        tb = torch.from_numpy(b).to(cuda, dtype)
        per_split = -(-k // splits // BLOCK_K[dtype]) * BLOCK_K[dtype]
        assert -(-k // per_split) == splits
        outs = []
        for _ in range(2):
            out = torch.empty((m, n), dtype=dtype, device=cuda)
            before = dense_wint8.launches
            outs.append(launch(tx, tq, ts, tb, out, splits, per_split))
            assert dense_wint8.launches == before + 1
        torch.cuda.synchronize()
        assert_wint8_close(tx, tq, ts, outs[0], dense_wint8_plain(tx, tq, ts, tb))
        assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["n_not_16", "k_not_8", "x_unaligned", "q_unaligned"])
def test_dense_wint8_kernel_element_route(cuda, dtype, case):
    """Shapes the 16-byte copies cannot take load element by element: N %
    16 != 0, K % 8 != 0, and x or q at a base not 16-byte aligned (a
    contiguous view at an odd element offset)."""
    m, k, n = {"n_not_16": (64, 1024, 1000), "k_not_8": (64, 1026, 1024),
               "x_unaligned": (64, 1024, 1024), "q_unaligned": (33, 256, 1024)}[case]
    x, q, s, b = wint8_inputs(m, k, n, seed=k + n)
    tx = torch.from_numpy(x).to(cuda, dtype)
    tq = torch.from_numpy(q).to(cuda)
    if case == "x_unaligned":
        tx = torch.cat([torch.zeros(1, dtype=dtype, device=cuda), tx.reshape(-1)])[1:]
        tx = tx.reshape(m, k)
        assert tx.is_contiguous() and tx.data_ptr() % 16 != 0
    if case == "q_unaligned":
        tq = torch.cat([torch.zeros(3, dtype=torch.int8, device=cuda), tq.reshape(-1)])[3:]
        tq = tq.reshape(k, n)
        assert tq.is_contiguous() and tq.data_ptr() % 16 != 0
    ts, tb = torch.from_numpy(s).to(cuda), torch.from_numpy(b).to(cuda, dtype)
    before = dense_wint8.launches
    got = dense_wint8(tx, tq, ts, tb)
    torch.cuda.synchronize()
    assert dense_wint8.launches == before + 1
    assert_wint8_close(tx, tq, ts, got, dense_wint8_plain(tx, tq, ts, tb))
    assert torch.equal(dense_wint8(tx, tq, ts, tb), got)


@pytest.mark.cuda
def test_dense_wint8_kernel_rejects_bad_plan(cuda):
    x, q, s, b = wint8_inputs(64, 1024, 1024)
    tx, tq, ts = (torch.from_numpy(v).to(cuda) for v in (x, q, s))
    out = torch.empty((64, 1024), device=cuda)
    for splits, per_split in ((9, 128), (2, 100), (4, 512), (2, 256)):
        with pytest.raises(RuntimeError, match="dense_wint8 launch failed"):
            launch(tx, tq, ts, None, out, splits, per_split)


# ---------------------------------------------------------- the planner (CPU)

# (M, K, N) of GPT-2 Medium's four per-layer products at the greedy row
# budget and at 256 beam lanes -> (splits, K per split) on 132 SMs, bf16 x
DECODER_PLANS = {
    (64, 1024, 3072): (4, 256), (64, 1024, 1024): (8, 128),
    (64, 1024, 4096): (4, 256), (64, 4096, 1024): (8, 512),
    (256, 1024, 3072): (2, 512), (256, 1024, 1024): (4, 256),
    (256, 1024, 4096): (2, 512), (256, 4096, 1024): (8, 512),
}


# the same shapes with f32 x (bound by operations): one wave of two blocks
# per SM, as many splits as fit
DECODER_PLANS_F32 = {
    (64, 1024, 3072): (8, 128), (64, 1024, 1024): (8, 128),
    (64, 1024, 4096): (8, 128), (64, 4096, 1024): (8, 512),
    (256, 1024, 3072): (2, 512), (256, 1024, 1024): (8, 128),
    (256, 1024, 4096): (2, 512), (256, 4096, 1024): (8, 512),
}


@pytest.mark.parametrize("dtype, shape", [
    pytest.param(dtype, s, id=prefix + "x".join(map(str, s)))
    for dtype, prefix, plans in ((torch.bfloat16, "", DECODER_PLANS),
                                 (torch.float32, "f32-", DECODER_PLANS_F32))
    for s in plans])
def test_dense_wint8_plan_at_decoder_shapes(dtype, shape):
    m, k, n = shape
    want = (DECODER_PLANS if dtype == torch.bfloat16 else DECODER_PLANS_F32)[shape]
    assert plan(m, n, k, dtype, 132) == want


def test_dense_wint8_plan_invariants():
    """Every plan the kernel can get: 1-8 splits (one portable cluster),
    K per split a whole number of K steps, every split non-empty, K
    covered."""
    rng = np.random.default_rng(0)
    shapes = [(int(m), int(n), int(k)) for m, n, k in rng.integers(1, 5000, (300, 3))]
    shapes += [(64, 1024, k) for k in range(0, 1300, 7)]
    for m, n, k in shapes:
        for dtype, block_k in BLOCK_K.items():
            for sms in (1, 16, 132):
                splits, per_split = plan(m, n, k, dtype, sms)
                assert 1 <= splits <= MAX_SPLITS
                assert per_split > 0 and per_split % block_k == 0
                assert splits * per_split >= k
                assert splits == 1 or (splits - 1) * per_split < k


# K3 at the beam path's shapes (B*K lanes, K = 4, 16 heads of 64 dims, 61
# slots) -> (beams and heads a block, slots a chunk, threads, smem bytes)
K3_PLANS = {
    torch.bfloat16: beam_attn.Plan(4, 1, 32, 128, 38912),
    torch.float32: beam_attn.Plan(4, 1, 16, 128, 36864),
    torch.int8: beam_attn.Plan(4, 1, 32, 128, 23552),
}


@pytest.mark.parametrize("bk", [256, 384])
@pytest.mark.parametrize("dtype", list(K3_PLANS), ids=["bf16", "f32", "int8"])
def test_beam_attention_plan_at_decoder_shapes(dtype, bk):
    assert beam_attn.plan(bk, 4, 16, 64, 61, dtype, 132) == K3_PLANS[dtype]


@pytest.mark.parametrize("dtype", list(K3_PLANS), ids=["bf16", "f32", "int8"])
def test_beam_attention_plan_invariants(dtype):
    """Every shape the kernel takes gets a plan it accepts (H <= 32, D <=
    128, T up to 1024, K up to 8 and beyond): the item's beams in one block
    up to 8, groups within K and H, a warp per (beam, head) pair and at
    most 16 pairs, 1-32 slots a chunk, shared memory as the kernel lays it
    out and within both the plan's budget and the card's 227 KB."""
    for heads in (1, 2, 5, 16, 32):
        for d in range(1, beam_attn.MAX_HEAD_DIM + 1):
            for k_beams in (1, 2, 3, 4, 5, 8, 12):
                for t in (1, 2, 13, 61, 64, 1024):
                    p = beam_attn.plan(k_beams * 3, k_beams, heads, d, t, dtype, 132)
                    assert p.beams == min(k_beams, beam_attn.MAX_BEAMS_PER_BLOCK)
                    assert 1 <= p.heads <= heads
                    assert p.beams * p.heads <= beam_attn.MAX_PAIRS
                    assert p.threads == 32 * p.beams * p.heads
                    assert 1 <= p.slots <= min(t, beam_attn.MAX_SLOTS)
                    assert p.smem == beam_attn.smem_bytes(dtype, d, p.beams, p.heads, p.slots)
                    assert p.smem <= min(beam_attn.SMEM_BUDGET, beam_attn.MAX_SMEM)


def test_k3_probe_patches_the_kernel():
    """tools/k3_probe.py finds each of its anchors in csrc/beam_attn.cu:
    three builds that stop early and three register bounds, each one change
    to the source."""
    from rgrg_tpu_torch.tools import k3_probe
    src = (kernels.CSRC / "beam_attn.cu").read_text()
    variants = k3_probe.variants()
    assert len(variants) == len(k3_probe.STOPS) + 3
    for name, text in variants.items():
        assert text != src or name == "min2", name
        assert text.count("return;") == src.count("return;") + name.startswith("stop"), name


def test_k12_probe_patches_the_kernel():
    """tools/k12_probe.py finds its anchors in csrc/roi_align.cu: the kernel
    as it is, one with plain stores, one on the one-channel route, one at
    most 64 registers a thread (each one change to the source) and one
    with bulk-copy stores on the 4-channel route (the kernel's own code
    kept for the one-channel route)."""
    from rgrg_tpu_torch.tools import k12_probe
    src = (kernels.CSRC / "roi_align.cu").read_text()
    variants = k12_probe.roi_variants()
    assert sorted(variants) == ["bounds8", "bulk_stores", "cached_stores", "one_channel",
                                "taps"]
    assert variants["taps"] == src
    assert variants["cached_stores"].count("#define __stcs") == 1
    assert variants["one_channel"].count("const bool vec = false &&") == 1
    assert variants["bounds8"].count("__launch_bounds__(kThreads, 8)") == 1
    for name in ("cached_stores", "one_channel", "bounds8"):
        assert len(variants[name].splitlines()) - len(src.splitlines()) in (0, 1)
    bulk = variants["bulk_stores"]
    assert bulk.count("if constexpr (V == 1) {") == 1 and bulk.count("cp.async.bulk.global") == 1
    assert bulk.count("{") == bulk.count("}") and src.count("{") == src.count("}")
    assert bulk.startswith(src[:src.index(k12_probe.BODY)])
    assert bulk.endswith(src[src.index(k12_probe.KERNEL_END):])

"""The port's box ops, resize, NMS (kernel K1) and RoIAlign (kernel K2)
against the JAX package on the CPU.

On the CPU the port's NMS and RoIAlign wrappers run their plain PyTorch
versions; these are held against the Pallas kernels in interpret mode, the
lax formulations and the scalar oracles. The kernels themselves run only
on a card: tests/test_torch_kernels.py compares each with its plain
version there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.core.config import AnchorConfig as JAnchorConfig
from rgrg_tpu.ops import anchors as j_anchors
from rgrg_tpu.ops import boxes as j_boxes
from rgrg_tpu.ops import nms as j_nms
from rgrg_tpu.ops.nms_pallas import nms_keep_mask_pallas
from rgrg_tpu.ops import resize as j_resize
from rgrg_tpu.ops.roi_align import roi_align as j_roi_align
from rgrg_tpu.ops.roi_align_pallas import roi_align_pallas_batched

from rgrg_tpu_torch.core.config import AnchorConfig
from rgrg_tpu_torch.core.device import resolve_device
from rgrg_tpu_torch.ops import anchors, boxes, resize
from rgrg_tpu_torch.ops.nms import (nms_keep_mask, nms_keep_mask_plain,
                                    nms_suppression_words, nms_sweep_words)
from rgrg_tpu_torch.ops.roi_align import (roi_align, roi_align_plain,
                                          roi_align_taps_plain, roi_align_weights,
                                          roi_tap_tables)

from tests.oracles import decode_boxes_oracle, nms_oracle
from tests.test_torch_kernels import (NMS_CASES, NMS_KINDS, NMS_SIZES, nms_case,
                                      nms_edge_case, random_boxes, roi_boxes,
                                      roi_edge_boxes, sweep_boxes)


# ---------------------------------------------------------------- box math

def test_grid_anchors_equal_jax():
    np.testing.assert_array_equal(anchors.grid_anchors(AnchorConfig()),
                                  j_anchors.grid_anchors(JAnchorConfig()))


def test_decode_clip_small_boxes_match_jax():
    rng = np.random.default_rng(0)
    ref = random_boxes(64, rng=rng)
    deltas = rng.normal(0, 2, (64, 30 * 4)).astype(np.float32)
    deltas[:3, 2:4] = 12.0  # beyond the exp clamp
    w = (10.0, 10.0, 5.0, 5.0)
    got = boxes.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(ref), w).numpy()
    want = np.asarray(j_boxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(ref), w))
    # exp may differ by an ulp between the two libraries
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got, decode_boxes_oracle(deltas, ref, w),
                               rtol=1e-5, atol=1e-3)
    clipped = boxes.clip_boxes_to_image(torch.from_numpy(got), 512, 512).numpy()
    np.testing.assert_array_equal(
        clipped, np.asarray(j_boxes.clip_boxes_to_image(jnp.asarray(got), 512, 512)))
    np.testing.assert_array_equal(
        boxes.remove_small_boxes_mask(torch.from_numpy(clipped), 1.0).numpy(),
        np.asarray(j_boxes.remove_small_boxes_mask(jnp.asarray(clipped), 1.0)))


# ---------------------------------------------------------------- resize

TAP_SHAPES = [(700, 600), (300, 200), (961, 1024), (2048, 2500), (512, 512)]


@pytest.mark.parametrize("shape", TAP_SHAPES, ids=[f"{h}x{w}" for h, w in TAP_SHAPES])
def test_resize_taps_equal_jax(shape):
    wy, wx = resize.resize_matrices(*shape)
    jwy, jwx = j_resize.resize_matrices(*shape)
    np.testing.assert_array_equal(wy, jwy)
    np.testing.assert_array_equal(wx, jwx)


# Exact-factor shapes: the resize sums are exact in f32, so the two
# libraries' different summation orders cannot move a .5 rounding boundary
# and the outputs must agree to 1e-6 (one uint8 step is 0.013 after
# normalization). (1024, 768) downscales by 2, (256, 200) upscales by 2.
EXACT_SHAPES = [(1024, 768), (256, 200)]


@pytest.mark.parametrize("shape", EXACT_SHAPES, ids=["downscale", "upscale"])
def test_device_preprocess_matches_jax(shape):
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (2, *shape), dtype=np.uint8)
    wy, wx = resize.resize_matrices(*shape)
    got = resize.device_preprocess(torch.from_numpy(imgs), torch.from_numpy(wy.copy()),
                                   torch.from_numpy(wx.copy())).numpy()
    want = np.asarray(j_resize.device_preprocess(jnp.asarray(imgs), wy, wx))
    assert got.shape == want.shape == (2, 512, 512, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(700, 600), (300, 200)], ids=["downscale", "upscale"])
def test_device_preprocess_fractional_taps(shape):
    """Fractional taps: JAX's f32 sums carry rounding noise that the port's
    float64 sums do not, so a pre-round value within ~1e-5 of .5 may round
    either way. Anything else is a bug: every pixel agrees to one uint8
    step, and all but a vanishing fraction exactly."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, *shape), dtype=np.uint8)
    wy, wx = resize.resize_matrices(*shape)
    got = resize.device_preprocess(torch.from_numpy(imgs), torch.from_numpy(wy.copy()),
                                   torch.from_numpy(wx.copy())).numpy()
    want = np.asarray(j_resize.device_preprocess(jnp.asarray(imgs), wy, wx))
    step = 1.0 / (0.302 * 255.0)
    diff = np.abs(got - want)
    assert diff.max() <= step * 1.001
    assert (diff > 1e-6).mean() < 1e-3


# ---------------------------------------------------------------- NMS (K1)


def _oracle_mask(b, valid, thr):
    """tests/oracles.py greedy NMS over the valid boxes (score = rank)."""
    idx = np.nonzero(valid)[0]
    mask = np.zeros(len(b), bool)
    if len(idx):
        scores = -np.arange(len(idx), dtype=np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            kept = nms_oracle(b[idx], scores, thr)
        mask[idx[kept]] = True
    return mask


@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_plain_identical_to_jax(name):
    b, valid, thr = nms_case(name)
    got = nms_keep_mask(torch.from_numpy(b)[None], torch.from_numpy(valid)[None],
                        thr)[0].numpy()
    pallas = np.asarray(nms_keep_mask_pallas(jnp.asarray(b), jnp.asarray(valid),
                                             thr, interpret=True))
    tiled = np.asarray(j_nms.nms_keep_mask_tiled(jnp.asarray(b), jnp.asarray(valid), thr))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, tiled)
    np.testing.assert_array_equal(got, _oracle_mask(b, valid, thr))
    assert not (got & ~valid).any()


def test_stable_topk_ties_match_lax_top_k():
    from rgrg_tpu_torch.models.detector import stable_topk
    rng = np.random.default_rng(6)
    x = rng.integers(0, 20, (3, 500)).astype(np.float32)  # many exact ties
    vals, idx = stable_topk(torch.from_numpy(x), 64)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_nms_batched_equals_per_image():
    cases = [nms_case(n) for n in ("n300_t05", "ties_duplicates")]
    n = 200
    b = np.stack([c[0][:n] for c in cases])
    v = np.stack([c[1][:n] for c in cases])
    got = nms_keep_mask_plain(torch.from_numpy(b), torch.from_numpy(v), 0.6).numpy()
    for i in range(2):
        want = np.asarray(j_nms.nms_keep_mask(jnp.asarray(b[i]), jnp.asarray(v[i]), 0.6))
        np.testing.assert_array_equal(got[i], want)


def test_nms_wrapper_cpu_dispatch_and_checks():
    b, valid, thr = nms_case("n300_t05")
    tb, tv = torch.from_numpy(b)[None], torch.from_numpy(valid)[None]
    before = nms_keep_mask.launches
    np.testing.assert_array_equal(nms_keep_mask(tb, tv, thr).numpy(),
                                  nms_keep_mask_plain(tb, tv, thr).numpy())
    assert nms_keep_mask.launches == before  # the plain version is no launch
    with pytest.raises(TypeError):
        nms_keep_mask(tb.double(), tv, thr)
    with pytest.raises(ValueError):
        nms_keep_mask(tb, tv[:, :10], thr)


# K1's design: a suppression word per (box, 64-box group), then a sweep

@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_bitmask_model_identical_to_jax(name):
    b, valid, thr = nms_case(name)
    tb, tv = torch.from_numpy(b)[None], torch.from_numpy(valid)[None]
    got = nms_sweep_words(nms_suppression_words(tb, thr), tv)[0].numpy()
    np.testing.assert_array_equal(got, nms_keep_mask_plain(tb, tv, thr)[0].numpy())
    pallas = np.asarray(nms_keep_mask_pallas(jnp.asarray(b), jnp.asarray(valid),
                                             thr, interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("kind", NMS_KINDS)
@pytest.mark.parametrize("n", NMS_SIZES)
def test_nms_bitmask_model_sizes(n, kind):
    """N around the 64-box groups and at the kernel's limit: the words hold
    bit k of group g for box j = 64 g + k after box i, nothing else, and
    their sweep equals the plain greedy mask."""
    b, valid, thr = nms_edge_case(n, kind)
    tb, tv = torch.from_numpy(b)[None], torch.from_numpy(valid)[None]
    words = nms_suppression_words(tb, thr)
    assert words.shape == (1, n, -(-n // 64)) and words.dtype == torch.int64
    bits = ((words[..., None] >> torch.arange(64)) & 1).flatten(-2).bool()  # [1, N, 64 G]
    later = torch.ones(n, n, dtype=torch.bool).triu(1)
    assert not bits[0, :, :n][~later].any() and not bits[..., n:].any()
    want = nms_keep_mask_plain(tb, tv, thr)
    np.testing.assert_array_equal(nms_sweep_words(words, tv).numpy(), want.numpy())
    if kind == "all_disjoint":
        assert bool(want.all())
    if kind == "chain":
        assert torch.equal(want[0], torch.arange(n) % 2 == 0)


# ---------------------------------------------------------------- RoIAlign (K2)

@pytest.mark.parametrize("c", [256, 512])
def test_roi_align_plain_matches_jax(c):
    """Tolerance 1e-5 (abs and rel): the same f32 weights and products,
    summed in a different order by each library."""
    rng = np.random.default_rng(c)
    feats = rng.normal(0, 1, (2, 16, 16, c)).astype(np.float32)
    bx = np.stack([roi_boxes(40, rng), roi_boxes(40, rng)])
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(bx)).numpy()
    assert got.shape == (2, 40, 8, 8, c) and got.dtype == np.float32
    pallas = np.asarray(roi_align_pallas_batched(jnp.asarray(feats), jnp.asarray(bx),
                                                 interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    for i in range(2):
        sep = np.asarray(j_roi_align(jnp.asarray(feats[i]), jnp.asarray(bx[i])))
        np.testing.assert_allclose(got[i], sep, rtol=1e-5, atol=1e-5)


def test_roi_align_plain_reads_bf16_as_f32():
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.normal(0, 1, (1, 16, 16, 64)).astype(np.float32))
    bx = torch.from_numpy(roi_boxes(16, rng)[None])
    bf = feats.to(torch.bfloat16)
    np.testing.assert_array_equal(roi_align_plain(bf, bx).numpy(),
                                  roi_align_plain(bf.float(), bx).numpy())


# K2's design: the nonzero taps of each bin row, at most 4

def _tap_boxes(kind):
    rng = np.random.default_rng(21)
    if kind == "roi_boxes":
        return np.stack([roi_boxes(64, rng), roi_boxes(64, rng)])
    return sweep_boxes(4096, rng).reshape(2, 2048, 4)


@pytest.mark.parametrize("kind", ["roi_boxes", "sweep"])
def test_roi_tap_tables_expand_to_dense(kind):
    """The tables hold every nonzero cell of Ay and Ax, in ascending order,
    with the dense weight's own value: scattered back they equal the dense
    rows exactly."""
    bx = torch.from_numpy(_tap_boxes(kind))
    dense = roi_align_weights(bx, 16, 16, 8, 1.0 / 32.0, 2)
    for (cells, weights, count), want in zip(roi_tap_tables(bx, 16, 16, 8, 1.0 / 32.0, 2),
                                             dense):
        assert cells.shape == weights.shape == want.shape[:-1] + (4,)
        assert torch.equal(count, (want != 0).sum(-1))
        got = torch.zeros_like(want).scatter_add_(-1, cells, weights)
        assert torch.equal(got, want)
        used = torch.arange(4) < count[..., None]
        assert bool((weights[used] != 0).all()) and not weights[~used].any()
        assert bool(((cells[..., 1:] > cells[..., :-1]) | ~used[..., 1:]).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roi_tap_tables_at_most_four_taps(seed):
    """Over negative, degenerate, out-of-map, sub-cell and wider-than-the-map
    boxes no bin row has more than 4 nonzero cells; the sweep reaches 0
    (bins off the map) and 4 (bins over two cells wide)."""
    bx = torch.from_numpy(sweep_boxes(20000, np.random.default_rng(seed)))
    counts = torch.cat([(w != 0).sum(-1).flatten()
                        for w in roi_align_weights(bx, 16, 16, 8, 1.0 / 32.0, 2)])
    assert int(counts.max()) == 4 and int(counts.min()) == 0


@pytest.mark.parametrize("c", [128])
def test_roi_align_taps_plain_matches_jax(c):
    """Pooling over the tap tables, in the kernel's order, within the 1e-5
    (abs and rel) of test_roi_align_plain_matches_jax: the same f32 weights
    and products, summed in another order."""
    rng = np.random.default_rng(c + 1)
    feats = rng.normal(0, 1, (2, 16, 16, c)).astype(np.float32)
    bx = np.stack([roi_edge_boxes(48, rng), np.concatenate([roi_boxes(40, rng),
                                                            sweep_boxes(8, rng)])])
    got = roi_align_taps_plain(torch.from_numpy(feats), torch.from_numpy(bx)).numpy()
    assert got.shape == (2, 48, 8, 8, c) and got.dtype == np.float32
    pallas = np.asarray(roi_align_pallas_batched(jnp.asarray(feats), jnp.asarray(bx),
                                                 interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, roi_align_plain(torch.from_numpy(feats), torch.from_numpy(bx)).numpy(),
        rtol=1e-5, atol=1e-5)


def test_roi_align_wrapper_checks():
    f = torch.zeros(1, 16, 16, 8)
    with pytest.raises(ValueError):
        roi_align(f, torch.zeros(2, 4, 4))
    with pytest.raises(ValueError):
        roi_align(f[0], torch.zeros(1, 4, 4))


# ---------------------------------------------------------------- device rule

def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"

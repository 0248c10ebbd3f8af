"""The port's train-time augmentations and RGRGDataset(train=True) against
the JAX package, on the CPU (whose transforms call cv2: 5.0.0 here).

- LUT ops and the jitter: identical, with albumentations' float32
  brightness / float64 contrast tables and the truncating uint8 clip.
- warp_affine_linear against cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT
  0) on random images and the matrices the pipeline draws: uint8 within
  one step everywhere and identical on at least 99.9% of pixels; float64
  within 1e-4 (pixel units). Measured on this host: identical on every
  pixel of every case below, uint8 and float64 alike (the uint8 copy
  reproduces cv2 5.0's float32 SIMD kernel as dispatched for AVX2, whose
  scalar tail rounds once more; the float64 copy its fixed-point 1/32-pixel
  path).
- train_transform at the same seed as JAX's, on images whose longest side
  is already 512 (the resize, one uint8 step from cv2's, stays out):
  images within one normalised uint8 step and identical on 99.9% of
  pixels, boxes within 1e-5, `keep` identical; each branch alone (jitter,
  noise, affine) and all three. On a full-size input the resize adds
  tests/test_torch_data.py's bound (one step, 99.99% exact).
- RGRGDataset(train=True): shuffled batches over two epochs equal to
  JAX's at the same seed, with workers 0 (one Generator for the order and
  the draws) and 2 (a SeedSequence per epoch and row), same tolerances.
"""

import numpy as np
import cv2
import pytest

from rgrg_tpu.data import transforms as JT
from rgrg_tpu.data.dataset import RGRGDataset as JDataset, read_split_csv as j_read
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer

from rgrg_tpu_torch.data import transforms as T
from rgrg_tpu_torch.data.dataset import RGRGDataset, read_split_csv
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

from tests.test_ops import random_boxes
from tests.test_torch_data import PIXEL_STEP, write_split

# longest side 512: no resize; row 2 names a missing file
SHAPES = [(512, 430), (480, 512), (512, 512), (512, 391), (400, 512), (512, 470),
          (512, 500), (451, 512)]


def _image_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= PIXEL_STEP
    assert (got == want).mean() >= 0.999


# ------------------------------------------------------------- LUT, jitter

@pytest.mark.parametrize("factor", [0.0, 0.8, 0.93, 1.0, 1.17, 1.2])
def test_lut_ops_identical(factor):
    rng = np.random.default_rng(int(factor * 100))
    img = rng.integers(0, 256, (64, 48), dtype=np.uint8)
    table = rng.integers(0, 256, 256).astype(np.uint8)
    np.testing.assert_array_equal(T.lut_uint8(img, table), cv2.LUT(img, table))
    np.testing.assert_array_equal(T.adjust_brightness_uint8(img, factor),
                                  JT.adjust_brightness_uint8(img, factor))
    np.testing.assert_array_equal(T.adjust_contrast_uint8(img, factor),
                                  JT.adjust_contrast_uint8(img, factor))


def test_brightness_f32_contrast_f64_tables_and_truncation():
    """Brightness builds its table in float32, contrast in float64: at
    factor 0.986666615874244 the float32 table gives 74 for 75 (75 x f is
    73.99999619 in float64, which truncates to 73). The clip truncates."""
    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for f in list(np.random.default_rng(0).uniform(0.8, 1.2, 200)) + [0.986666615874244]:
        np.testing.assert_array_equal(T.adjust_brightness_uint8(img, f),
                                      JT.adjust_brightness_uint8(img, f))
        np.testing.assert_array_equal(T.adjust_contrast_uint8(img, f),
                                      JT.adjust_contrast_uint8(img, f))
    b = T.adjust_brightness_uint8(img, 0.986666615874244)
    assert b[4, 11] == 74 and b[9, 6] == 148          # pixels 75 and 150
    assert T.adjust_brightness_uint8(img, 1.199)[15, 15] == 255
    assert T.adjust_brightness_uint8(np.full((1, 1), 3, np.uint8), 0.9)[0, 0] == 2   # 2.7


def test_color_jitter_identical_in_every_order():
    img = np.random.default_rng(1).integers(0, 256, (40, 30), dtype=np.uint8)
    for seed in range(12):
        p = T.sample_aug_params(np.random.default_rng(seed), 40, 30)
        if not p.jitter:
            continue
        jp = JT.sample_aug_params(np.random.default_rng(seed), 40, 30)
        assert p.order == jp.order and p.brightness == jp.brightness
        np.testing.assert_array_equal(T.color_jitter_gray_uint8(img, p),
                                      JT.color_jitter_gray_uint8(img, jp))


# ------------------------------------------------------------------- warp

def _drawn_affine(seed, h, w):
    """The first draw of sample_aug_params at or after `seed` that fires
    the affine branch, as the pipeline draws it."""
    for s in range(seed, seed + 64):
        p = T.sample_aug_params(np.random.default_rng(s), h, w)
        if p.affine:
            return T.affine_matrix(p.angle, p.tx, p.ty, h, w)
    raise AssertionError("no affine draw")


@pytest.mark.parametrize("case", range(6))
def test_warp_affine_linear_matches_cv2(case):
    """uint8 and float64 (a uint8 image plus unclipped noise), at widths
    that do and do not fill the 16-wide vectors, plus an exaggerated 25
    degree rotation with a 40 px shift (taps far outside the image)."""
    rng = np.random.default_rng(case)
    h, w = [(512, 430), (512, 512), (391, 512), (512, 447), (300, 200), (512, 429)][case]
    m = _drawn_affine(case * 7, h, w)
    if case == 4:
        m = T.affine_matrix(25.0, 40.0, -40.0, h, w)
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    got = T.warp_affine_linear(img, m[:2], (w, h))
    want = cv2.warpAffine(img, m[:2], (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())
    noisy = img.astype(np.float32) + rng.normal(0.0, 5.0, img.shape)
    got = T.warp_affine_linear(noisy, m[:2], (w, h))
    want = cv2.warpAffine(noisy, m[:2], (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(TypeError, match="uint8 or float64"):
        T.warp_affine_linear(noisy.astype(np.float32), m[:2], (w, h))


# -------------------------------------------------------- train_transform

def _seed_for(branches, h, w):
    """The first seed whose draw fires exactly these (jitter, noise,
    affine) branches."""
    for s in range(200):
        p = T.sample_aug_params(np.random.default_rng(s), h, w)
        if (p.jitter, p.noise, p.affine) == branches:
            return s
    raise AssertionError(branches)


@pytest.mark.parametrize("branches", [(True, False, False), (False, True, False),
                                      (False, False, True), (True, True, True),
                                      (False, False, False)],
                         ids=["jitter", "noise", "affine", "all", "none"])
def test_train_transform_matches_jax(branches):
    h, w = 512, 437
    rng = np.random.default_rng(sum(branches) + 10 * branches[2])
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    boxes = random_boxes(29, extent=float(w), rng=rng)
    boxes[0] = [w - 12, 100, w, 300]        # against the right edge
    boxes[1] = [0, 0, 6, 5]                 # a small corner box
    seed = _seed_for(branches, h, w)
    got_img, got_boxes, got_keep = T.train_transform(img, boxes, np.random.default_rng(seed))
    want_img, want_boxes, want_keep = JT.train_transform(img, boxes,
                                                         np.random.default_rng(seed))
    assert got_img.shape == (512, 512, 1)
    _image_close(got_img, want_img)
    np.testing.assert_array_equal(got_keep, want_keep)
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=1e-5)
    # the draws after the transform's are where JAX's are
    ga, wa = np.random.default_rng(seed), np.random.default_rng(seed)
    T.train_transform(img, boxes, ga)
    JT.train_transform(img, boxes, wa)
    assert ga.uniform() == wa.uniform()


def test_train_boxes_clip_at_prepad_frame():
    """After the warp, boxes clip against the resized pre-pad frame, so a
    box pushed past the right edge stops there and never reaches into the
    zero padding (tests/test_data.py's check, on the port)."""
    img = np.random.default_rng(0).integers(0, 255, (700, 600)).astype(np.uint8)
    boxes = np.array([[560, 100, 600, 400], [0, 0, 600, 700]], np.float32)
    scaled_w = round(600 * 512 / 700)
    left = (512 - scaled_w) // 2
    for seed in range(30):
        _, b, keep = T.train_transform(img, boxes, np.random.default_rng(seed))
        assert keep.all() and (b[:, 0] >= left).all() and (b[:, 2] <= scaled_w + left).all()


def test_filter_boxes_drops_boxes_pushed_outside():
    boxes = np.array([[-30, 10, -2, 40], [5, 5, 20, 20], [500, 0, 530, 9]], np.float32)
    for (gb, gk), (wb, wk) in [(T.filter_boxes(boxes, 500, 400),
                                JT.filter_boxes(boxes, 500, 400))]:
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gk, [False, True, False])
        np.testing.assert_array_equal(gk, wk)
    m = T.affine_matrix(1.5, 3.0, -2.0, 512, 437)
    np.testing.assert_array_equal(T.transform_boxes_affine(boxes, m),
                                  JT.transform_boxes_affine(boxes, m))


# ---------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("train_split"), seed=3, shapes=SHAPES,
                       empty_report_row=-1)


@pytest.mark.parametrize("workers", [0, 2])
def test_train_dataset_batches_match_jax_over_two_epochs(split, workers):
    """Shuffled, augmented batches of 3 (the missing row skipped) over two
    epochs of one dataset object per package; the second epoch differs from
    the first."""
    ds = RGRGDataset(read_split_csv(split), GPT2Tokenizer.dummy(), train=True, seq_len=24)
    jds = JDataset(j_read(split), JTokenizer.dummy(), train=True, seq_len=24)
    epochs = []
    for epoch in range(2):
        got = list(ds.batches(3, shuffle=True, workers=workers))
        want = list(jds.batches(3, shuffle=True, workers=workers))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if k == "images":
                    for gi, wi in zip(g[k], w[k]):
                        _image_close(gi, wi)
                elif k == "gt_boxes":
                    np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5)
                elif isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                else:
                    assert g[k] == w[k], k
        epochs.append(got)
    assert any((a["images"] != b["images"]).any() for a, b in zip(*epochs))
    # a fresh dataset at the same seed repeats the first epoch
    again = list(RGRGDataset(read_split_csv(split), GPT2Tokenizer.dummy(), train=True,
                             seq_len=24).batches(3, shuffle=True, workers=workers))
    assert all(np.array_equal(a["images"], b["images"]) for a, b in zip(again, epochs[0]))

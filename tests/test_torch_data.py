"""The port's evaluation data path against the JAX package: the split csv
read without pandas, the eval transforms without cv2, RGRGDataset batches
(workers 0 and 2) and prefetching.

The split: PNGs written by cv2 at shapes that downscale, upscale, already
fit and need no resize, one unreadable path, one empty `reference_report`
cell (NaN in pandas, and so in the port's rows). The port resizes with
data/preprocess.py (the numpy copy of native/preprocess.cc), JAX's dataset
with cv2. Images must agree within one uint8 step after normalisation
(1.01 / (0.302 * 255)) everywhere, and on fractional downscales (every
MIMIC-CXR image) and unresized shapes with at least 99.99% of pixels
exact, the bound of tests/test_native.py for that resize. On upscales and
exact-factor downscales cv2's uint8 kernels round in fixed point, so the
bound there is tests/test_resize_device.py's for cv2 (under 12% of pixels
a step off). Everything else must be equal.
"""

import csv
import math
import sys

import numpy as np
import cv2
import pytest

from rgrg_tpu.data import transforms as JT
from rgrg_tpu.data.dataset import RGRGDataset as JDataset, read_split_csv as j_read
from rgrg_tpu.data.prefetch import prefetched as j_prefetched
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer

from rgrg_tpu_torch.data import transforms as T
from rgrg_tpu_torch.data.dataset import RGRGDataset, read_split_csv, row_to_sample
from rgrg_tpu_torch.data.prefetch import prefetched, prefetched_factory
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

from tests.test_ops import random_boxes

PATH_COLUMNS = ("mimic_image_file_path", "bbox_coordinates", "bbox_labels",
                "bbox_phrases", "bbox_phrase_exists", "bbox_is_abnormal",
                "reference_report")
PIXEL_STEP = 1.01 / (0.302 * 255)
SHAPES = [(700, 600), (300, 200), (512, 512), (1024, 768), (450, 512), (600, 700),
          (257, 1000), (512, 400)]
# upscales and exact-factor downscales: cv2 rounds in fixed point there
FIXED_POINT_SHAPES = {(300, 200), (1024, 768)}
PHRASES = ["The heart is normal.", "No pleural effusion ___.", "Lungs are clear.",
           "Stable 1.5 cm nodule.", "T12 compression, unchanged.", ""]


def write_split(dir_path, seed=0, shapes=SHAPES, name="split.csv", empty_report_row=3):
    """A split csv in the ETL's schema over cv2-written PNGs; row 2 names a
    missing file and `empty_report_row` has an empty reference_report."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, shape in enumerate(shapes):
        path = dir_path / f"img{i}.png"
        cv2.imwrite(str(path), rng.integers(0, 256, shape, dtype=np.uint8))
        labels = sorted(rng.choice(np.arange(1, 30), 20, replace=False).tolist())
        h, w = shape
        boxes = random_boxes(20, extent=float(min(h, w)), rng=rng).round(1)
        phrases = [PHRASES[int(rng.integers(0, len(PHRASES)))] for _ in range(29)]
        rows.append({
            "subject_id": str(1000 + i),
            "mimic_image_file_path": str(dir_path / "missing.png") if i == 2 else str(path),
            "bbox_coordinates": str(boxes.tolist()),
            "bbox_labels": str(labels),
            "bbox_phrases": str(phrases),
            "bbox_phrase_exists": str([bool(p) for p in phrases]),
            "bbox_is_abnormal": str([bool(rng.uniform() < 0.3) for _ in phrases]),
            "reference_report": "" if i == empty_report_row else " ".join(phrases[:4]),
        })
    path = dir_path / name
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return str(path)


def assert_image_close(got, want, shape):
    assert np.abs(got - want).max() <= PIXEL_STEP, shape
    exact = (got == want).mean()
    assert exact >= (0.88 if shape in FIXED_POINT_SHAPES else 0.9999), (shape, exact)


def same_value(a, b):
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    return type(a) is type(b) and a == b


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("split"))


def test_read_split_csv_matches_pandas(split):
    rows, df = read_split_csv(split), j_read(split)
    assert len(rows) == len(df) == len(SHAPES)
    for i, row in enumerate(rows):
        want = df.iloc[i]
        for col in PATH_COLUMNS:
            assert same_value(row[col], want[col]), (i, col, row[col], want[col])
    assert math.isnan(rows[3]["reference_report"]) and bool(rows[3]["reference_report"])
    # usecols / nrows
    sub, jsub = read_split_csv(split, usecols=PATH_COLUMNS[:3], nrows=2), \
        j_read(split, usecols=list(PATH_COLUMNS[:3]), nrows=2)
    assert [list(r) for r in sub] == [list(jsub.columns)] * len(jsub) and len(sub) == 2
    with pytest.raises(ValueError, match="no column"):
        read_split_csv(split, usecols=["nope"])


@pytest.mark.parametrize("shape", SHAPES + [(2048, 2500)])
def test_val_transform_matches_jax(shape):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    boxes = random_boxes(29, extent=float(min(shape)), rng=rng)
    got, gb = T.val_transform(image, boxes)
    want, wb = JT.val_transform(image, boxes)
    assert got.shape == want.shape == (512, 512, 1) and got.dtype == want.dtype
    np.testing.assert_array_equal(gb, wb)
    assert_image_close(got, want, shape)
    # the steps alone
    (gi, gbx), (wi, wbx) = T.longest_max_size(image, 512, boxes), \
        JT.longest_max_size(image, 512, boxes)
    assert gi.shape == wi.shape and gi.dtype == wi.dtype
    assert np.abs(gi.astype(int) - wi.astype(int)).max() <= 1
    np.testing.assert_array_equal(gbx, wbx)
    small = image[:100, :80]
    for a, b in zip(T.pad_to_square(small, 512, boxes), JT.pad_to_square(small, 512, boxes)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(T.normalize(small, T.TransformConfig()),
                                  JT.normalize(small, JT.TransformConfig()))


def test_load_image_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    gray, color = tmp_path / "g.png", tmp_path / "c.png"
    cv2.imwrite(str(gray), rng.integers(0, 65535, (40, 30), dtype=np.uint16))
    cv2.imwrite(str(color), rng.integers(0, 256, (40, 30, 3), dtype=np.uint8))
    for p in (gray, color):
        np.testing.assert_array_equal(T.load_image(str(p)), JT.load_image(str(p)))
    with pytest.raises(FileNotFoundError):
        T.load_image(str(tmp_path / "missing.png"))


def check_batches(got, want):
    """Batch for batch; the images by the source shape of their row (the
    unreadable row 2 is skipped)."""
    assert len(got) == len(want) > 0
    shapes = iter([s for i, s in enumerate(SHAPES) if i != 2])
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k == "images":
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                for gi, wi in zip(g[k], w[k]):
                    assert_image_close(gi, wi, next(shapes))
            elif k == "reference_reports":
                assert all(same_value(a, b) for a, b in zip(g[k], w[k])), k
            elif isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("workers", [0, 2])
def test_dataset_batches_match_jax(split, workers):
    tok, jtok = GPT2Tokenizer.dummy(), JTokenizer.dummy()
    ds = RGRGDataset(read_split_csv(split), tok, seq_len=24)
    jds = JDataset(j_read(split), jtok, train=False, seq_len=24)
    assert len(ds) == len(jds)
    for drop_last in (True, False):
        got = list(ds.batches(3, drop_last=drop_last, workers=workers))
        want = list(jds.batches(3, drop_last=drop_last, workers=workers))
        check_batches(got, want)
    # the unreadable row is skipped; the empty report stays NaN
    assert sum(len(b["reference_reports"]) for b in got) == len(SHAPES) - 1
    assert any(isinstance(r, float) and math.isnan(r) for b in got
               for r in b["reference_reports"])


def test_prefetched_batches_match_jax(split):
    tok, jtok = GPT2Tokenizer.dummy(), JTokenizer.dummy()
    ds = RGRGDataset(read_split_csv(split), tok)
    jds = JDataset(j_read(split), jtok, train=False)
    check_batches(list(prefetched(ds.batches(2, workers=2), depth=2)),
                  list(j_prefetched(jds.batches(2), depth=2)))
    assert list(prefetched(iter(range(50)), depth=3)) == list(range(50))
    factory = prefetched_factory(lambda: iter(range(5)), depth=1)
    assert list(factory()) == list(factory()) == list(range(5))

    def failing():
        yield 1
        raise KeyError("producer")
    it = prefetched(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer"):
        next(it)


@pytest.mark.parametrize("workers", [0, 2])
def test_missing_image_decoder_raises(split, monkeypatch, workers):
    """Without cv2 (a machine that lacks it) reading an image file raises
    ImportError: a missing decoder is not an unreadable sample, so the
    dataset does not skip every row of the split."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    rows = read_split_csv(split)
    with pytest.raises(ImportError):
        row_to_sample(rows[0])
    with pytest.raises(ImportError):
        next(RGRGDataset(rows, None).batches(2, workers=workers))


def test_train_mode_waits_for_the_training_slice(split):
    """train=True, which the training slice ported, builds augmented
    samples (tests/test_torch_augment.py holds them against JAX); an
    unreadable row is skipped in either mode."""
    rows = read_split_csv(split)
    ds = RGRGDataset(rows, GPT2Tokenizer.dummy(), train=True)
    assert ds.train and ds[0].image.shape == (512, 512, 1)
    assert row_to_sample(rows[2]) is None  # the unreadable row
    assert row_to_sample(rows[2], train=True, rng=np.random.default_rng(0)) is None
    assert row_to_sample(rows[0]).image.shape == (512, 512, 1)

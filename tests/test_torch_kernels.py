"""Kernels K1 (csrc/nms.cu) and K2 (csrc/roi_align.cu) against their plain
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

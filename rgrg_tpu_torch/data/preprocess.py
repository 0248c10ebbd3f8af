"""Host preprocessing of X-rays: longest-max-size resize to 512, uint8-domain
rounding, centre pad, normalise.

A numpy copy of the C++ host pipeline the JAX package runs before its
detector (native/preprocess.cc), operation for operation, so that both
packages feed their detectors the same bits:

  - downscale: separable area averaging. Per-axis taps are computed in
    double and stored as float (area_axis_weights); each pass accumulates
    in float32, tap by tap in the C++ order (horizontal: acc += w[k] * px;
    vertical: out = w[0] * row0, then out += w[k] * row_k). The passes are
    vectorised over output pixels with a loop over the tap index; a tap
    past an output's own count has weight 0 and adds exactly 0;
  - upscale: cv2 INTER_AREA's area-mode two-tap interpolation in float64
    (resize_area_upscale), with scale = 1 / (dst / src) as cv2 derives it;
  - the resized image is rounded half to even to the uint8 domain, centred
    on a canvas of the normalised zero, and normalised as
    (q - mean * 255) / (std * 255) in float32.

numpy evaluates each operation on its own, so nothing is fused into an FMA
(the C++ is built with -ffp-contract=off for the same reason). No cv2.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import math
import os
from typing import Sequence, Tuple

import numpy as np

from rgrg_tpu_torch.core import constants as C


@functools.lru_cache(maxsize=256)
def area_axis_weights(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """Area-downscale taps of one axis: (start [dst] int64, taps [dst, T]
    float32). Output o averages source cells start[o] .. start[o]+T-1 with
    their fractional coverage, normalised to sum 1; taps past o's own
    count are 0. Coverage and its total are double, each tap is stored as
    float(float(cov) / total), as the C++ does."""
    scale = src / dst
    start = np.zeros(dst, np.int64)
    rows = []
    for o in range(dst):
        a0, a1 = o * scale, (o + 1) * scale
        i0 = int(a0)
        i1 = min(int(math.ceil(a1)), src)
        covs = [min(i + 1, a1) - max(i, a0) for i in range(i0, i1)]
        total = 0.0
        for c in covs:  # in order: sum() compensates its additions
            total += c
        start[o] = i0
        rows.append([np.float32(float(np.float32(c)) / total) for c in covs])
    taps = np.zeros((dst, max(len(r) for r in rows)), np.float32)
    for o, r in enumerate(rows):
        taps[o, :len(r)] = r
    for a in (start, taps):
        a.setflags(write=False)  # shared through the cache
    return start, taps


def resize_area(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Separable area-average downscale, uint8 [sh, sw] -> float32 [dh, dw]
    (unrounded)."""
    sh, sw = src.shape
    sy, wy = area_axis_weights(sh, dh)
    sx, wx = area_axis_weights(sw, dw)
    tmp = np.zeros((sh, dw), np.float32)  # horizontal pass: [sh, sw] -> [sh, dw]
    for k in range(wx.shape[1]):
        # gather the uint8 tap column first (np.take is ~4x faster than a
        # fancy index here), then widen: uint8 -> float32 is exact
        px = np.take(src, np.minimum(sx + k, sw - 1), axis=1).astype(np.float32)
        px *= wx[:, k]
        tmp += px
    out = wy[:, :1] * tmp[sy]              # vertical pass: [sh, dw] -> [dh, dw]
    for k in range(1, wy.shape[1]):
        out += wy[:, k:k + 1] * tmp[np.minimum(sy + k, sh - 1)]
    return out


def resize_area_upscale(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2 INTER_AREA upscale, uint8 [sh, sw] -> float32 [dh, dw]: two taps
    per axis, s0 = floor(o * scale), f = (o + 1) - (s0 + 1) * inv,
    f = f <= 0 ? 0 : f - floor(f), blended in float64."""
    sh, sw = src.shape

    def axis(s: int, d: int):
        inv = d / s
        scale = 1.0 / inv
        o = np.arange(d)
        i0 = np.floor(o * scale).astype(np.int64)
        f = (o + 1) - (i0 + 1) * inv
        f = np.where(f <= 0, 0.0, f - np.floor(f))
        return i0, np.minimum(i0 + 1, s - 1), f

    y0, y1, ly = axis(sh, dh)
    x0, x1, lx = axis(sw, dw)
    p = src.astype(np.float64)
    ly, lx = ly[:, None], lx[None, :]
    top = (1 - lx) * p[y0][:, x0] + lx * p[y0][:, x1]
    bot = (1 - lx) * p[y1][:, x0] + lx * p[y1][:, x1]
    return ((1 - ly) * top + ly * bot).astype(np.float32)


def preprocess_one(src: np.ndarray) -> np.ndarray:
    """One uint8 [H, W] image -> float32 [512, 512] (module docstring)."""
    size = C.IMAGE_SIZE
    sh, sw = src.shape
    scale = size / max(sh, sw)
    dh = max(1, round(sh * scale))  # half to even, as Python's round and nearbyint
    dw = max(1, round(sw * scale))
    if dh == sh and dw == sw:
        resized = src.astype(np.float32)
    elif scale < 1.0:
        resized = resize_area(src, dh, dw)
    else:
        resized = resize_area_upscale(src, dh, dw)
    top = max((size - dh) // 2, 0)
    left = max((size - dw) // 2, 0)
    denom = np.float32(C.IMAGE_STD) * np.float32(255.0)
    bias = np.float32(C.IMAGE_MEAN) * np.float32(255.0)
    out = np.full((size, size), (np.float32(0.0) - bias) / denom, np.float32)
    out[top:top + dh, left:left + dw] = (np.rint(resized) - bias) / denom
    return out


def preprocess_batch(images: Sequence[np.ndarray]) -> np.ndarray:
    """Grayscale [H, W] images (any shapes; cast to uint8 as the C++
    binding does) -> [N, 512, 512, 1] float32, the images spread over a
    thread pool of one thread per CPU (numpy releases the GIL)."""
    arrays = [np.ascontiguousarray(im, np.uint8) for im in images]
    out = np.empty((len(arrays), C.IMAGE_SIZE, C.IMAGE_SIZE), np.float32)

    def one(i: int) -> None:
        out[i] = preprocess_one(arrays[i])

    workers = min(os.cpu_count() or 1, len(arrays))
    if workers <= 1:
        for i in range(len(arrays)):
            one(i)
    else:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(one, range(len(arrays))))
    return out[..., None]

"""On-device image preprocessing: resize + pad + normalize as two matmuls.

Both resize modes (area averaging for a downscale, cv2 INTER_AREA's
area-mode two-tap interpolation for an upscale) are linear in the source
pixels and separable. The host builds per-axis weight matrices
`wy [512, H]` / `wx [W, 512]` once per input shape (numpy, float64
coordinate math, float32 taps, no FMA), with the centering pad as zero
rows/cols; the device then computes

    q   = round(wy @ img_u8 @ wx)      # two float64 matmuls, never TF32
    out = (q - mean*255) / (std*255)

`torch.round` rounds half to even, as the host pipeline does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from rgrg_tpu_torch.core import constants as C


def _area_axis_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] fractional-coverage area-average weights (rows sum to 1):
    per output cell, the coverage of each source cell under the forward
    map. cov and total accumulate in double; the stored tap is
    float32(float(float32(cov)) / total)."""
    scale = src / dst
    w = np.zeros((dst, src), np.float32)
    for o in range(dst):
        a0, a1 = o * scale, (o + 1) * scale
        i0 = int(a0)
        i1 = min(int(np.ceil(a1)), src)
        covs = [min(i + 1, a1) - max(i, a0) for i in range(i0, i1)]
        total = sum(covs)
        for i, cov in zip(range(i0, i1), covs):
            w[o, i] = np.float32(float(np.float32(cov)) / total)
    return w


def _area_upscale_axis_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] cv2 INTER_AREA upscale weights (<= 2 taps per row):
    s0 = floor(o*scale), f = (o+1) - (s0+1)*dst/src,
    f = f <= 0 ? 0 : f - floor(f), with scale = 1/(dst/src) as cv2 derives
    it (not src/dst: the 1-ulp difference moves floor(o*scale) where o*scale
    is an exact integer)."""
    inv = dst / src
    scale = 1.0 / inv
    w = np.zeros((dst, src), np.float32)
    for o in range(dst):
        i0 = int(np.floor(o * scale))
        f = (o + 1) - (i0 + 1) * inv
        f = 0.0 if f <= 0 else f - np.floor(f)
        i1 = min(i0 + 1, src - 1)
        lo = np.float32(f)
        w[o, i0] += np.float32(1.0) - lo
        w[o, i1] += lo
    return w


def _axis_matrix(src: int, dst: int, scale: float) -> np.ndarray:
    if dst == src:
        return np.eye(dst, dtype=np.float32)
    if scale < 1.0:
        return _area_axis_weights(src, dst)
    return _area_upscale_axis_weights(src, dst)


@functools.lru_cache(maxsize=256)
def resize_matrices(sh: int, sw: int, size: int = C.IMAGE_SIZE
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(wy [size, sh], wx [sw, size]) for one source shape.

    Longest-max-size target dims round half to EVEN (Python round, as
    albumentations' LongestMaxSize does: 961x1024 -> 480 rows, not 481);
    top/left = (size - d) // 2; rows/cols outside the resized window are
    zero, which after the affine normalization yields the pad value."""
    scale = size / max(sh, sw)
    dh = max(1, round(sh * scale))
    dw = max(1, round(sw * scale))
    top = max((size - dh) // 2, 0)
    left = max((size - dw) // 2, 0)
    wy = np.zeros((size, sh), np.float32)
    wy[top:top + dh] = _axis_matrix(sh, dh, scale)
    wx = np.zeros((sw, size), np.float32)
    wx[:, left:left + dw] = _axis_matrix(sw, dw, scale).T
    wy.setflags(write=False)  # shared by every caller through the cache
    wx.setflags(write=False)
    return wy, wx


def device_preprocess(images_u8: torch.Tensor, wy: torch.Tensor,
                      wx: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W] uint8 -> [B, size, size, 1] normalized, on the tensors'
    device. wy/wx are the f32 resize_matrices on the same device.

    The two products run in float64: a TF32 product (what cuBLAS runs for
    f32 matmuls while `allow_tf32` is set) keeps ~10 mantissa bits and
    would flip uint8 roundings wholesale, and float64 avoids it without
    touching that process-wide flag. Taps are f32, pixels 8-bit, so the
    products are exact and the sums round only at ~1e-16: the result
    rounds as the exact resize does, on any device."""
    x = images_u8.to(torch.float64)
    r = torch.matmul(wy.to(torch.float64), x)   # [size, H] @ [B, H, W] -> [B, size, W]
    r = torch.matmul(r, wx.to(torch.float64))   # [B, size, W] @ [W, size] -> [B, size, size]
    q = torch.round(r).to(torch.float32)        # uint8-domain quantization, half-even
    denom = float(np.float32(C.IMAGE_STD * 255.0))
    bias = float(np.float32(C.IMAGE_MEAN * 255.0))
    out = (q - bias) / denom
    return out[..., None].to(out_dtype)

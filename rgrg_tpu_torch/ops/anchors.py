"""Anchor grid generation (numpy, host side).

The layout is a constant of the fixed 512x512 input / 16x16 C5 map (160
anchors per cell, 40,960 in all). Ordering contract, shared with the RPN
head's flattened outputs: base anchors aspect-ratio-major, size-minor,
corners rounded half-to-even; the grid row-major over (y, x) with anchors
contiguous per cell.
"""

from __future__ import annotations

import functools

import numpy as np

from rgrg_tpu_torch.core.config import AnchorConfig


def base_anchors(cfg: AnchorConfig) -> np.ndarray:
    """[A, 4] zero-centered anchors, A = len(aspect_ratios) * len(sizes)."""
    scales = np.asarray(cfg.sizes, dtype=np.float32)
    ratios = np.asarray(cfg.aspect_ratios, dtype=np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * scales[None, :]).reshape(-1)
    anchors = np.stack([-ws, -hs, ws, hs], axis=1) / 2.0
    return np.round(anchors).astype(np.float32)  # half-to-even


@functools.lru_cache(maxsize=8)
def grid_anchors(cfg: AnchorConfig) -> np.ndarray:
    """[grid*grid*A, 4] anchors in image coordinates; cached per config."""
    base = base_anchors(cfg)
    g = cfg.grid_size
    shifts_x = np.arange(g, dtype=np.float32) * cfg.stride
    shifts_y = np.arange(g, dtype=np.float32) * cfg.stride
    sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)
    out = np.ascontiguousarray(all_anchors, dtype=np.float32)
    out.setflags(write=False)  # shared by every caller through the cache
    return out

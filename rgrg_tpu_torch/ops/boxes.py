"""Box math on tensors, always in float32.

Boxes are `[..., 4]` in (x1, y1, x2, y2) corner format; every function is
shape-polymorphic over leading batch dims. Operation order follows the JAX
package's ops/boxes.py so f32 results agree to rounding.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# the box coder clamps dw/dh before exp at log(1000/16)
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
                 ) -> torch.Tensor:
    """Apply regression deltas [..., K*4] to reference boxes [..., 4].
    Returns [..., K, 4] (torchvision BoxCoder.decode_single semantics)."""
    boxes = boxes.to(deltas.dtype)
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    k4 = deltas.shape[-1]
    if k4 % 4:
        raise ValueError(f"deltas last dim {k4} not a multiple of 4")
    d = deltas.reshape(deltas.shape[:-1] + (k4 // 4, 4))
    wx, wy, ww, wh = weights
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = torch.clamp(d[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(d[..., 3] / wh, max=BBOX_XFORM_CLIP)

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    x1 = pred_ctr_x - 0.5 * pred_w
    y1 = pred_ctr_y - 0.5 * pred_h
    x2 = pred_ctr_x + 0.5 * pred_w
    y2 = pred_ctr_y + 0.5 * pred_h
    return torch.stack([x1, y1, x2, y2], dim=-1)


def clip_boxes_to_image(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Clamp corners into [0, W] x [0, H]."""
    x = torch.clamp(boxes[..., 0::2], 0.0, width)
    y = torch.clamp(boxes[..., 1::2], 0.0, height)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def remove_small_boxes_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Boolean mask of boxes with both sides >= min_size."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


def encode_boxes(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
                 ) -> torch.Tensor:
    """Inverse of decode: the regression targets [..., 4] that map
    `proposals` onto `reference_boxes` (both [..., 4])."""
    wx, wy, ww, wh = weights
    ex_widths = proposals[..., 2] - proposals[..., 0]
    ex_heights = proposals[..., 3] - proposals[..., 1]
    ex_ctr_x = proposals[..., 0] + 0.5 * ex_widths
    ex_ctr_y = proposals[..., 1] + 0.5 * ex_heights

    gt_widths = reference_boxes[..., 2] - reference_boxes[..., 0]
    gt_heights = reference_boxes[..., 3] - reference_boxes[..., 1]
    gt_ctr_x = reference_boxes[..., 0] + 0.5 * gt_widths
    gt_ctr_y = reference_boxes[..., 1] + 0.5 * gt_heights

    dx = wx * (gt_ctr_x - ex_ctr_x) / ex_widths
    dy = wy * (gt_ctr_y - ex_ctr_y) / ex_heights
    dw = ww * torch.log(gt_widths / ex_widths)
    dh = wh * torch.log(gt_heights / ex_heights)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., N, M] of boxes1 [..., N, 4] and boxes2 [..., M, 4]
    (leading dims broadcast): inter / ((area1 + area2) - inter), no epsilon.
    The anchor matcher compares these for equality, so the operation order
    is the JAX package's."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union

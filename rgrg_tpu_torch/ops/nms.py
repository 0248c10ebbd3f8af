"""Exact greedy NMS keep mask over score-sorted proposals, batched.

`nms_keep_mask` is the entry the detector calls: on a CPU tensor it runs
the plain PyTorch version below, on a CUDA tensor it launches kernel K1
(csrc/nms.cu, one block per image, one launch per call) or raises. Callers
pass boxes already sorted by score descending plus a validity mask and get
a keep mask over the same fixed-size array: no compaction, static shapes.
"""

from __future__ import annotations

import torch

from rgrg_tpu_torch.ops import kernels

MAX_BOXES = 2048  # csrc/nms.cu keeps one image's boxes in shared memory


def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """[B, N, 4] -> [B, N, N] IoU with the reference's formula and order:
    inter / ((area_a + area_b) - inter), no epsilon (0/0 -> NaN)."""
    a = boxes[:, :, None, :]
    b = boxes[:, None, :, :]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    return inter / (area_a + area_b - inter)


def nms_keep_mask_plain(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch greedy NMS: boxes [B, N, 4] f32 score-sorted, valid
    [B, N] bool -> keep [B, N] bool. Step i lets box i, if still kept,
    suppress every later box whose IoU with it exceeds the threshold;
    invalid boxes are never kept and never suppress."""
    n = boxes.shape[1]
    iou = pairwise_iou(boxes.to(torch.float32))
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (iou > iou_threshold) & later               # [B, N, N]: i kills j
    keep = valid.clone()
    for i in range(n):
        keep &= ~(sup[:, i, :] & keep[:, i:i + 1])
    return keep


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, N, 4], got {tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:2]:
        raise ValueError(f"valid must be [B, N] = {tuple(boxes.shape[:2])}, "
                         f"got {tuple(valid.shape)}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"boxes must be float32 and valid bool, got "
                        f"{boxes.dtype} / {valid.dtype}")
    if boxes.device != valid.device:
        raise ValueError("boxes and valid must be on one device")


def nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float) -> torch.Tensor:
    """boxes [B, N, 4] f32 sorted by score descending, valid [B, N] bool
    -> keep [B, N] bool. CPU tensors: the plain version. CUDA tensors: one
    launch of kernel K1 covering all B images (counted in
    `nms_keep_mask.launches`)."""
    _check(boxes, valid)
    if boxes.device.type == "cpu":
        return nms_keep_mask_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    bsz, n = valid.shape
    if n > MAX_BOXES:
        raise ValueError(f"N={n} boxes per image exceeds the kernel's {MAX_BOXES}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    keep = torch.empty((bsz, n), dtype=torch.bool, device=boxes.device)
    if bsz == 0 or n == 0:
        return keep
    lib = kernels.library("nms")
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    code = lib.rgrg_nms_keep_mask(boxes.data_ptr(), valid.data_ptr(),
                                  keep.data_ptr(), bsz, n,
                                  float(iou_threshold), stream)
    kernels.check(lib, code, "nms_keep_mask")
    nms_keep_mask.launches += 1
    return keep


nms_keep_mask.launches = 0

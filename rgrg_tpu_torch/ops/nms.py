"""Exact greedy NMS keep mask over score-sorted proposals, batched.

`nms_keep_mask` is the entry the detector calls: on a CPU tensor it runs
the plain PyTorch version below, on a CUDA tensor it launches kernel K1
(csrc/nms.cu: a suppression bitmask, then a sweep of it, two launches per
call) or raises. Callers pass boxes already sorted by score descending plus
a validity mask and get a keep mask over the same fixed-size array: no
compaction, static shapes.

`nms_suppression_words` and `nms_sweep_words` are plain models of the
kernel's two steps, with its bit order and group boundaries; the tests hold
them against the plain version and the kernel's words against them. They
are never on the main path.
"""

from __future__ import annotations

import torch

from rgrg_tpu_torch.ops import kernels

MAX_BOXES = 2048  # csrc/nms.cu: one removed-word per lane of one warp
GROUP = 64       # boxes per suppression word


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


def groups(n: int) -> int:
    """64-box groups (suppression words per box) of an image of n boxes."""
    return -(-n // GROUP)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """[..., 64] bool -> [...] int64 holding the bits of a uint64 (bit k =
    entry k). Distinct powers of two: the sum is the OR, bit 63 included
    (int64 wraps)."""
    one = torch.ones((), dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) * (one << torch.arange(GROUP, device=bits.device))).sum(-1)


def nms_suppression_words(boxes: torch.Tensor,
                          iou_threshold: float) -> torch.Tensor:
    """boxes [B, N, 4] f32 -> words [B, N, ceil(N / 64)] int64 (the bits of
    uint64): bit k of word (i, g) is set iff box j = 64 g + k comes after
    box i and i suppresses j (IoU above the threshold; NaN sets no bit)."""
    bsz, n = boxes.shape[:2]
    g = groups(n)
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (pairwise_iou(boxes.to(torch.float32)) > iou_threshold) & later
    return _pack(torch.nn.functional.pad(sup, (0, g * GROUP - n)).view(bsz, n, g, GROUP))


def nms_sweep_words(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """words [B, N, G] from `nms_suppression_words`, valid [B, N] bool ->
    keep [B, N] bool. The removed-word of each group starts from ~valid;
    box i of group g is kept iff its bit of removed-word g is clear, and a
    kept box ORs its row of words into the removed-words."""
    bsz, n = valid.shape
    g = groups(n)
    invalid = torch.nn.functional.pad(~valid, (0, g * GROUP - n), value=True)
    removed = _pack(invalid.view(bsz, g, GROUP))                        # [B, G]
    keep = torch.zeros_like(valid)
    for i in range(n):
        kept = (removed[:, i // GROUP] >> (i % GROUP)) & 1 == 0          # [B]
        keep[:, i] = kept
        removed = torch.where(kept[:, None], removed | words[:, i], removed)
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
    -> keep [B, N] bool. CPU tensors: the plain version. CUDA tensors:
    kernel K1 covering all B images, its words then its sweep (one count in
    `nms_keep_mask.launches` per call)."""
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
    words = torch.empty((bsz, n, groups(n)), dtype=torch.int64, device=boxes.device)
    lib = kernels.library("nms")
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    code = lib.rgrg_nms_keep_mask(boxes.data_ptr(), valid.data_ptr(),
                                  keep.data_ptr(), words.data_ptr(), bsz, n,
                                  float(iou_threshold), stream)
    kernels.check(lib, code, "nms_keep_mask")
    nms_keep_mask.launches += 1
    return keep


nms_keep_mask.launches = 0


def nms_words(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """K1's words step alone: boxes [B, N, 4] f32 on the card -> words
    [B, N, ceil(N / 64)] int64, equal bit for bit to
    `nms_suppression_words` (the words of column groups before a box's own
    group, which the sweep never reads, are zero here). For tests and
    timing; not on the main path and not counted."""
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_words launches on the card, got {boxes.device}")
    bsz, n = boxes.shape[:2]
    if boxes.dtype != torch.float32 or not boxes.is_contiguous() or not 0 < n <= MAX_BOXES:
        raise ValueError("boxes must be contiguous f32 [B, N, 4] with 0 < N <= "
                         f"{MAX_BOXES}")
    words = torch.zeros((bsz, n, groups(n)), dtype=torch.int64, device=boxes.device)
    lib = kernels.library("nms")
    code = lib.rgrg_nms_words(boxes.data_ptr(), words.data_ptr(), bsz, n,
                              float(iou_threshold),
                              torch.cuda.current_stream(boxes.device).cuda_stream)
    kernels.check(lib, code, "nms_words")
    return words

"""RoIAlign (aligned=False) over a batch of NHWC feature maps.

Bilinear interpolation over the (sampling x sampling) sample grid of a bin
is separable, so each pooled bin is

    out[p, q, c] = sum_h Ay[p, h] * sum_w Ax[q, w] * F[h, w, c]

with per-ROI 1-D weight matrices Ay [P, H] / Ax [P, W] (min ROI size 1,
samples outside [-1, extent] dropped, negative coordinates clamped to 0,
cells at extent-1 capped with zero upper weight).

`roi_align` is the entry the detector calls: on a CPU tensor it runs the
plain PyTorch version below, on a CUDA tensor it launches kernel K2
(csrc/roi_align.cu) or raises.
"""

from __future__ import annotations

import torch

from rgrg_tpu_torch.ops import kernels


def axis_weights(start: torch.Tensor, bin_size: torch.Tensor, extent: int,
                 pooled: int, sampling: int) -> torch.Tensor:
    """start/bin_size [...] -> [..., pooled, extent] f32 interpolation
    weights, with the float operations of the reference's weight builder."""
    p = torch.arange(pooled, dtype=torch.float32, device=start.device)[:, None]
    grid = torch.arange(extent, dtype=torch.float32, device=start.device)
    start = start[..., None, None]
    b = bin_size[..., None, None]
    acc = torch.zeros(start.shape[:-2] + (pooled, extent),
                      dtype=torch.float32, device=start.device)
    for s in range(sampling):
        y = start + p * b + (s + 0.5) * b / sampling           # [..., P, 1]
        valid = (y >= -1.0) & (y <= extent)
        yc = torch.clamp(y, min=0.0)
        y_low = torch.floor(yc)
        cap = y_low >= extent - 1
        y_low = torch.where(cap, torch.full_like(y_low, extent - 1.0), y_low)
        y_high = torch.where(cap, torch.full_like(y_low, extent - 1.0), y_low + 1.0)
        ly = torch.where(cap, torch.zeros_like(yc), yc - y_low)
        hy = 1.0 - ly
        w = (hy * (grid == y_low).to(torch.float32)
             + ly * (grid == y_high).to(torch.float32))
        acc = acc + w * valid.to(torch.float32)
    return acc / sampling


def roi_align_weights(boxes: torch.Tensor, height: int, width: int,
                      output_size: int, spatial_scale: float, sampling: int):
    """boxes [..., 4] image coords -> (Ay [..., P, H], Ax [..., P, W])."""
    boxes = boxes.to(torch.float32)
    start_w = boxes[..., 0] * spatial_scale
    start_h = boxes[..., 1] * spatial_scale
    roi_w = torch.clamp(boxes[..., 2] * spatial_scale - start_w, min=1.0)
    roi_h = torch.clamp(boxes[..., 3] * spatial_scale - start_h, min=1.0)
    ay = axis_weights(start_h, roi_h / output_size, height, output_size, sampling)
    ax = axis_weights(start_w, roi_w / output_size, width, output_size, sampling)
    return ay, ax


def roi_align_plain(features: torch.Tensor, boxes: torch.Tensor, *,
                    output_size: int = 8, spatial_scale: float = 1.0 / 32.0,
                    sampling_ratio: int = 2) -> torch.Tensor:
    """Plain PyTorch RoIAlign: features [B, H, W, C] (any float dtype, read
    as f32), boxes [B, N, 4] -> [B, N, P, P, C] f32. Contracts H, then W."""
    _, h, w, _ = features.shape
    ay, ax = roi_align_weights(boxes, h, w, output_size, spatial_scale,
                               sampling_ratio)
    f = features.to(torch.float32)
    tmp = torch.einsum("bnph,bhwc->bnpwc", ay, f)
    return torch.einsum("bnpwc,bnqw->bnpqc", tmp, ax)


def _check(features: torch.Tensor, boxes: torch.Tensor) -> None:
    if features.ndim != 4:
        raise ValueError(f"features must be [B, H, W, C], got {tuple(features.shape)}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or boxes.shape[0] != features.shape[0]:
        raise ValueError(f"boxes must be [B, N, 4] with B={features.shape[0]}, "
                         f"got {tuple(boxes.shape)}")
    if features.device != boxes.device:
        raise ValueError("features and boxes must be on one device")


def roi_align(features: torch.Tensor, boxes: torch.Tensor, *,
              output_size: int = 8, spatial_scale: float = 1.0 / 32.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """features [B, H, W, C], boxes [B, N, 4] f32 -> [B, N, P, P, C] f32.
    CPU tensors: the plain version. CUDA tensors: one launch of kernel K2
    (counted in `roi_align.launches`), which takes f32 or bf16 features on
    the model's geometry (16x16 map, 8x8 bins, sampling 2)."""
    _check(features, boxes)
    if features.device.type == "cpu":
        return roi_align_plain(features, boxes, output_size=output_size,
                               spatial_scale=spatial_scale,
                               sampling_ratio=sampling_ratio)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    bsz, h, w, c = features.shape
    n = boxes.shape[1]
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if (h, w, output_size, sampling_ratio) != (16, 16, 8, 2):
        raise ValueError("the kernel is built for a 16x16 map, 8x8 bins and "
                         f"sampling 2; got map {h}x{w}, {output_size} bins, "
                         f"sampling {sampling_ratio}")
    if not (features.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("features and boxes must be contiguous")
    out = torch.empty((bsz, n, output_size, output_size, c),
                      dtype=torch.float32, device=features.device)
    if bsz == 0 or n == 0 or c == 0:
        return out
    lib = kernels.library("roi_align")
    stream = torch.cuda.current_stream(features.device).cuda_stream
    code = lib.rgrg_roi_align(features.data_ptr(),
                              int(features.dtype == torch.bfloat16),
                              boxes.data_ptr(), out.data_ptr(), bsz, h, w, c,
                              n, output_size, sampling_ratio,
                              float(spatial_scale), stream)
    kernels.check(lib, code, "roi_align")
    roi_align.launches += 1
    return out


roi_align.launches = 0

"""RoIAlign (aligned=False) over a batch of NHWC feature maps.

Bilinear interpolation over the (sampling x sampling) sample grid of a bin
is separable, so each pooled bin is

    out[p, q, c] = sum_h Ay[p, h] * sum_w Ax[q, w] * F[h, w, c]

with per-ROI 1-D weight matrices Ay [P, H] / Ax [P, W] (min ROI size 1,
samples outside [-1, extent] dropped, negative coordinates clamped to 0,
cells at extent-1 capped with zero upper weight).

`roi_align` is the entry the detector calls: on a CPU tensor it runs the
plain PyTorch version below, on a CUDA tensor it launches kernel K2
(csrc/roi_align.cu) or raises. On both devices it is one
torch.autograd.Function: the output is linear in the features, and the
feature gradient is the transposed fused contraction

    dF[b] = W2[b]^T . G[b],   W2[b, (n, p, q), (h, w)] = Ay[b, n, p, h] * Ax[b, n, q, w]

one batched matmul [B, H*W, N*P*P] x [B, N*P*P, C] (`roi_align_feature_grad`),
deterministic (no atomics). Boxes get no gradient.

A row of Ay or Ax has at most 2 samples x 2 cells = 4 nonzero weights.
`roi_tap_tables` keeps only those, as the kernel does, and
`roi_align_taps_plain` pools over them in the kernel's order (W first,
then H, ascending cells); the tests hold both against the dense weights
and the JAX package. They are never on the main path.
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
    as f32, or f64 for f64 features), boxes [B, N, 4] -> [B, N, P, P, C] in
    that dtype. Contracts H, then W."""
    _, h, w, _ = features.shape
    ay, ax = roi_align_weights(boxes, h, w, output_size, spatial_scale,
                               sampling_ratio)
    f = features.to(torch.promote_types(features.dtype, torch.float32))
    ay, ax = ay.to(f.dtype), ax.to(f.dtype)
    tmp = torch.einsum("bnph,bhwc->bnpwc", ay, f)
    return torch.einsum("bnpwc,bnqw->bnpqc", tmp, ax)


MAX_TAPS = 4  # nonzero cells of one weight row: 2 samples x 2 cells


def roi_tap_tables(boxes: torch.Tensor, height: int, width: int,
                   output_size: int, spatial_scale: float, sampling: int):
    """boxes [..., 4] -> ((cells_y, weights_y, count_y), (cells_x, weights_x,
    count_x)): per axis the nonzero cells of each bin row of Ay / Ax in
    ascending order, cells [..., P, 4] int64 and weights [..., P, 4] f32
    (padded with cell 0, weight 0), count [..., P] int64. The weights are
    the dense rows' own values."""
    if sampling != MAX_TAPS // 2:
        raise ValueError(f"the tables hold 2 samples x 2 cells, got sampling {sampling}")
    tables = []
    for dense in roi_align_weights(boxes, height, width, output_size,
                                   spatial_scale, sampling):
        nonzero = dense != 0
        count = nonzero.sum(-1)
        extent = dense.shape[-1]
        # nonzero cells first, in ascending order; then the zero cells
        order = torch.argsort(torch.where(nonzero, 0, extent)
                              + torch.arange(extent, device=dense.device), dim=-1)
        cells = order[..., :MAX_TAPS]
        weights = torch.gather(dense, -1, cells)
        pad = torch.arange(MAX_TAPS, device=dense.device) >= count[..., None]
        tables.append((cells.masked_fill(pad, 0), weights.masked_fill(pad, 0.0), count))
    return tuple(tables)


def roi_align_taps_plain(features: torch.Tensor, boxes: torch.Tensor, *,
                         output_size: int = 8, spatial_scale: float = 1.0 / 32.0,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign over the tap tables, in the kernel's order: for each bin
    (p, q), sum over the row taps h of Ay[p, h] * (sum over the column taps
    w of Ax[q, w] * F[h, w, c]). Same signature and result as
    `roi_align_plain`."""
    bsz, h, w, c = features.shape
    (cy, wy, _), (cx, wx, _) = roi_tap_tables(boxes, h, w, output_size,
                                              spatial_scale, sampling_ratio)
    f = features.to(torch.float32).reshape(bsz, h * w, c)
    n, p = boxes.shape[1], output_size
    out = torch.zeros((bsz, n, p, p, c), dtype=torch.float32, device=features.device)
    for t in range(MAX_TAPS):
        u = torch.zeros_like(out)
        for s in range(MAX_TAPS):
            cell = cy[..., :, None, t] * w + cx[..., None, :, s]            # [B, N, P, P]
            v = torch.gather(f, 1, cell.reshape(bsz, -1, 1).expand(-1, -1, c))
            u = u + wx[..., None, :, s, None] * v.view(bsz, n, p, p, c)
        out = out + wy[..., :, None, t, None] * u
    return out


def _check(features: torch.Tensor, boxes: torch.Tensor) -> None:
    if features.ndim != 4:
        raise ValueError(f"features must be [B, H, W, C], got {tuple(features.shape)}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or boxes.shape[0] != features.shape[0]:
        raise ValueError(f"boxes must be [B, N, 4] with B={features.shape[0]}, "
                         f"got {tuple(boxes.shape)}")
    if features.device != boxes.device:
        raise ValueError("features and boxes must be on one device")


def roi_align_feature_grad(grad: torch.Tensor, boxes: torch.Tensor, height: int,
                           width: int, *, output_size: int = 8,
                           spatial_scale: float = 1.0 / 32.0,
                           sampling_ratio: int = 2) -> torch.Tensor:
    """The gradient of RoIAlign's output with respect to its features:
    grad [B, N, P, P, C] (f32, or f64) -> dF [B, H, W, C] in grad's dtype,
    as one batched matmul dF[b] = W2[b]^T . G[b] over the fused weights
    W2 [B, N*P*P, H*W] of the boxes."""
    bsz, n, p, _, c = grad.shape
    ay, ax = roi_align_weights(boxes, height, width, output_size, spatial_scale,
                               sampling_ratio)
    w2 = (ay[:, :, :, None, :, None] * ax[:, :, None, :, None, :]).to(grad.dtype)
    w2 = w2.reshape(bsz, n * p * p, height * width)
    return torch.bmm(w2.transpose(1, 2), grad.reshape(bsz, n * p * p, c)
                     ).reshape(bsz, height, width, c)


def _launch(features: torch.Tensor, boxes: torch.Tensor, output_size: int,
            spatial_scale: float, sampling_ratio: int) -> torch.Tensor:
    """One launch of kernel K2 (counted in `roi_align.launches`)."""
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


class RoIAlign(torch.autograd.Function):
    """Forward: the plain version on the CPU, kernel K2 on the card.
    Backward: `roi_align_feature_grad` on either device."""

    @staticmethod
    def forward(ctx, features, boxes, output_size, spatial_scale, sampling_ratio):
        ctx.save_for_backward(boxes)
        ctx.geometry = (features.shape[1], features.shape[2], features.dtype,
                        output_size, spatial_scale, sampling_ratio)
        if features.device.type == "cpu":
            return roi_align_plain(features, boxes, output_size=output_size,
                                   spatial_scale=spatial_scale,
                                   sampling_ratio=sampling_ratio)
        if features.device.type != "cuda":
            raise ValueError(f"unsupported device {features.device}")
        return _launch(features, boxes, output_size, spatial_scale, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        h, w, dtype, output_size, spatial_scale, sampling_ratio = ctx.geometry
        grad = grad.to(torch.promote_types(grad.dtype, torch.float32))
        d_features = roi_align_feature_grad(
            grad, boxes, h, w, output_size=output_size,
            spatial_scale=spatial_scale, sampling_ratio=sampling_ratio)
        return d_features.to(dtype), None, None, None, None


def roi_align(features: torch.Tensor, boxes: torch.Tensor, *,
              output_size: int = 8, spatial_scale: float = 1.0 / 32.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """features [B, H, W, C], boxes [B, N, 4] f32 -> [B, N, P, P, C] f32,
    differentiable in the features (`RoIAlign`). CPU tensors: the plain
    version. CUDA tensors: one launch of kernel K2 (counted in
    `roi_align.launches`; the backward launches none), which takes f32 or
    bf16 features on the model's geometry (16x16 map, 8x8 bins, sampling 2).
    Boxes must not require grad."""
    _check(features, boxes)
    if boxes.requires_grad:
        raise ValueError("roi_align gives no gradient to its boxes: pass them "
                         "detached")
    return RoIAlign.apply(features, boxes, output_size, float(spatial_scale),
                          sampling_ratio)


roi_align.launches = 0

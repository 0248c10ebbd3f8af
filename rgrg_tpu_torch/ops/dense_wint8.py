"""Dense product over weight-only int8 weights (kernel K4).

    y = (x @ q) * scale (+ bias), cast to x's dtype

x [..., K] bf16 or f32 (leading dims flattened), q [K, N] int8, scale N
f32 per-output-channel scales ([N] or [1, N]), bias [N] f32 or bf16. The
sum runs in f32 and the scale is applied to it: (x @ q) * s equals
x @ (q * s) exactly, so only the int8 bytes of the weights need reading.
This is the `"pallas"` layout of gpt2.quantize_decoder_weights.

`dense_wint8` is the entry the decoder calls: on a CPU tensor it runs the
plain PyTorch version below, on a CUDA tensor it launches kernel K4
(csrc/dense_wint8.cu) for every shape, or raises.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from rgrg_tpu_torch.ops import kernels

# the kernel's tiling (csrc/dense_wint8.cu): 64 x 64 output tiles, K steps
# of 64 (bf16 x) or 32 (f32 x), at most 8 K-splits per tile
TILE = 64
BLOCK_K = {torch.bfloat16: 64, torch.float32: 32}
MAX_SPLITS = 8

_X_KIND = {torch.float32: 0, torch.bfloat16: 1}
_BIAS_KIND = {torch.float32: 1, torch.bfloat16: 2}

# per device: the zeroed per-tile arrival counts of the split-K fixup (the
# kernel leaves them zero again when it ends)
_counts: Dict[torch.device, torch.Tensor] = {}


def dense_wint8_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the product in f32, scaled, biased, cast."""
    n = q.shape[1]
    y = torch.matmul(x.to(torch.float32), q.to(torch.float32)) * scale.reshape(n)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def _check(x, q, scale, bias) -> None:
    if q.ndim != 2 or q.dtype != torch.int8:
        raise TypeError(f"q must be int8 [K, N], got {q.dtype} {tuple(q.shape)}")
    k, n = q.shape
    if x.ndim < 1 or x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not end in K={k}")
    if x.dtype not in _X_KIND:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype != torch.float32 or scale.numel() != n:
        raise ValueError(f"scale must be float32 with N={n} elements, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if bias is not None and (bias.dtype not in _BIAS_KIND or bias.numel() != n):
        raise ValueError(f"bias must be float32 or bfloat16 with N={n} elements, "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    tensors = [x, q, scale] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one device")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(m: int, n: int, k: int, block_k: int, sms: int):
    """(splits, K per split): the fewest power-of-two K-splits (at most
    MAX_SPLITS, at most one per K step) that give the launch at least two
    blocks per SM; K per split is a whole number of K steps and no split
    is empty."""
    tiles = -(-m // TILE) * -(-n // TILE)
    steps = -(-k // block_k)
    splits = 1
    while splits < MAX_SPLITS and tiles * splits < 2 * sms and 2 * splits <= steps:
        splits *= 2
    per_split = max(-(-steps // splits), 1) * block_k
    return max(-(-k // per_split), 1), per_split


def _tile_counts(device: torch.device, tiles: int) -> torch.Tensor:
    buf = _counts.get(device)
    if buf is None or buf.numel() < tiles:
        buf = _counts[device] = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                                            device=device)
    return buf


def dense_wint8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y [..., N] in x's dtype (module docstring). CPU tensors: the plain
    version. CUDA tensors: one launch of kernel K4 (counted in
    `dense_wint8.launches`) for any shape; all inputs must be contiguous.
    K4 keeps per-tile counts on the device between launches, so calls on
    one device must come from one stream at a time."""
    _check(x, q, scale, bias)
    lead, (k, n) = x.shape[:-1], q.shape
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        return dense_wint8_plain(x2, q, scale, bias).reshape(lead + (n,))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tensors = [x2, q, scale] + ([bias] if bias is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, q, scale and bias must be contiguous")
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out.reshape(lead + (n,))
    dev = x.device if x.device.index is not None else torch.device(
        "cuda", torch.cuda.current_device())
    splits, per_split = split_k(m, n, k, BLOCK_K[x.dtype], _sm_count(dev.index))
    ws = (torch.empty(splits * m * n, dtype=torch.float32, device=dev)
          if splits > 1 else None)
    counts = _tile_counts(dev, -(-m // TILE) * -(-n // TILE))
    lib = kernels.library("dense_wint8")
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.rgrg_dense_wint8(
        x2.data_ptr(), _X_KIND[x.dtype], q.data_ptr(), scale.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        _BIAS_KIND[bias.dtype] if bias is not None else 0, out.data_ptr(),
        ws.data_ptr() if ws is not None else None, counts.data_ptr(),
        m, n, k, splits, per_split, stream)
    kernels.check(lib, code, "dense_wint8")
    dense_wint8.launches += 1
    return out.reshape(lead + (n,))


dense_wint8.launches = 0

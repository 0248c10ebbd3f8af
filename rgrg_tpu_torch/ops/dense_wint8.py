"""Dense product over weight-only int8 weights (kernel K4).

    y = (x @ q) * scale (+ bias), cast to x's dtype

x [..., K] bf16 or f32 (leading dims flattened), q [K, N] int8, scale N
f32 per-output-channel scales ([N] or [1, N]), bias [N] f32 or bf16. The
sum runs in f32 and the scale is applied to it: (x @ q) * s equals
x @ (q * s) exactly, so only the int8 bytes of the weights need reading.
This is the `"pallas"` layout of gpt2.quantize_decoder_weights.

`dense_wint8` is the entry the decoder calls: on a CPU tensor it runs the
plain PyTorch version below, on a CUDA tensor it launches kernel K4
(csrc/dense_wint8.cu) for every shape, or raises. `plan` chooses the
launch (how many blocks of one thread block cluster split K); it is pure
Python so that the CPU tests pin its choices.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from rgrg_tpu_torch.ops import kernels

# the kernel's tiling (csrc/dense_wint8.cu): 64 x 128 output tiles, K steps
# of 64 (bf16 x) or 32 (f32 x), at most 8 K-splits (one cluster) per tile
TILE_M = 64
TILE_N = 128
BLOCK_K = {torch.bfloat16: 64, torch.float32: 32}
MAX_SPLITS = 8

_X_KIND = {torch.float32: 0, torch.bfloat16: 1}
_BIAS_KIND = {torch.float32: 1, torch.bfloat16: 2}


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
    dev = x.get_device()  # -1 on the CPU
    if (q.get_device() != dev or scale.get_device() != dev
            or (bias is not None and bias.get_device() != dev)):
        raise ValueError("all inputs must be on one device")


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, dtype: torch.dtype, sms: int) -> Tuple[int, int]:
    """(splits, K per split) of one launch over M x N x K with x of `dtype`.
    Output tiles are 64 x 128; K is split over a power of two of blocks
    (one cluster), at most MAX_SPLITS (the portable cluster size) and at
    most one per K step. bf16 x, bound by the weight stream: the fewest
    splits that give the launch at least one block per two SMs and each
    block at most 8 K steps (on the H100 a block streams its share of K at
    a few tens of GB/s, so long shares are slow, while clusters of many
    blocks per SM do not all fit at once). f32 x, FMA on CUDA cores and
    bound by operations: the most splits that still fit one wave of two
    blocks per SM. K per split is a whole number of K steps, and splits
    shrink until none is empty. PERF.md has the time of every split count
    at the decoder's shapes."""
    block_k = BLOCK_K[dtype]
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    steps = -(-k // block_k)
    splits = 1
    if dtype == torch.float32:
        while 2 * splits <= min(MAX_SPLITS, steps) and 2 * splits * tiles <= 2 * sms:
            splits *= 2
    else:
        want = max(-(-sms // (2 * tiles)), -(-steps // 8))
        while splits < min(MAX_SPLITS, steps) and splits < want:
            splits *= 2
    per_split = max(-(-steps // splits), 1) * block_k
    return max(-(-k // per_split), 1), per_split


def launch(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
           bias: Optional[torch.Tensor], out: torch.Tensor, splits: int,
           per_split: int) -> torch.Tensor:
    """One launch of K4 writing out [M, N] from contiguous CUDA x2 [M, K],
    q, scale and bias, K split `splits` ways of `per_split` each (the
    kernel checks the plan). Counted in `dense_wint8.launches`."""
    m, k = x2.shape
    lib = kernels.library("dense_wint8")
    code = lib.rgrg_dense_wint8(
        x2.data_ptr(), _X_KIND[x2.dtype], q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        0 if bias is None else _BIAS_KIND[bias.dtype], out.data_ptr(),
        m, q.shape[1], k, splits, per_split, kernels.raw_stream(x2.get_device()))
    kernels.check(lib, code, "dense_wint8")
    dense_wint8.launches += 1
    return out


def dense_wint8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y [..., N] in x's dtype (module docstring). CPU tensors: the plain
    version. CUDA tensors: one launch of kernel K4 (counted in
    `dense_wint8.launches`) for any shape; all inputs must be contiguous.
    Allocates only the output. The decoder calls it 96 times a decode
    step, so the CUDA route reads each attribute once and reshapes only
    inputs that are not 2-D. It has no backward: with grad enabled, an
    input that requires grad raises rather than getting a result cut off
    from the graph."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        raise RuntimeError("dense_wint8 has no backward; call it under "
                           "torch.no_grad() or with inputs that need no grad")
    _check(x, q, scale, bias)
    k, n = q.shape
    flat = x.dim() == 2
    x2 = x if flat else x.reshape(-1, k)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        y = dense_wint8_plain(x2, q, scale, bias)
        return y if flat else y.reshape(x.shape[:-1] + (n,))
    if not (x2.is_contiguous() and q.is_contiguous() and scale.is_contiguous()
            and (bias is None or bias.is_contiguous())):
        raise ValueError("x, q, scale and bias must be contiguous")
    m = x2.shape[0]
    out = x2.new_empty((m, n))
    if m and n:
        splits, per_split = plan(m, n, k, x.dtype, kernels.sm_count(x.get_device()))
        launch(x2, q, scale, bias, out, splits, per_split)
    return out if flat else out.reshape(x.shape[:-1] + (n,))


dense_wint8.launches = 0

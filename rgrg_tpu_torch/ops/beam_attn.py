"""Ancestry-masked attention of one beam-decode step (kernel K3).

The beam cache is never reordered. Lane r = b*K + k of layer i's cache
holds whatever token beam k of item b produced at each slot when it was
written, and the ancestry table names, for each live beam and each slot,
the beam of the same item whose lane holds that slot's K/V:

    q      [B*K, H, D]     the step's queries (bf16 or f32)
    k, v   [H, B*K, T, D]  this layer's cache (bf16, f32, or int8 with
                           k_scale/v_scale [H, B*K, T, 1] f32)
    anc    [B, K, T] int32 ancestor beam (0..K-1) of slot t for beam k
    ctx[r, h] = sum_{t0 <= t <= slot} softmax_t(scale * q[r, h] . K_t) * V_t
    with K_t = k[h, b*K + anc[b, k, t], t]  (V_t likewise)

Slots outside [t0, slot] get no weight. The JAX package adds a -1e4 bias
(XLA path) or -1e9 (Pallas kernel) to them instead; at these scores either
underflows to exactly 0 in the f32 softmax, so leaving the slots out
computes the same function. Scores, softmax and the context are f32;
an int8 cache is dequantised on load (value * scale).

`beam_attention` is the entry the decoder calls: on a CPU tensor it runs
the plain PyTorch version below, on a CUDA tensor it launches kernel K3
(csrc/beam_attn.cu) or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from rgrg_tpu_torch.ops import kernels

# the kernel's limits: one warp per head (a block per query row), a lane
# holds at most 4 of the head dims
MAX_HEADS = 32
MAX_HEAD_DIM = 128

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _dequant(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    xf = x.to(torch.float32)
    return xf * scale if scale is not None else xf


def beam_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         anc: torch.Tensor, slot: int, *, scale: float,
                         t0: int = 0, k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: gather the ancestry-named K/V rows of the
    visible slots, then softmax attention in f32. Returns ctx [B*K, H, D]
    f32."""
    bk, h, d = q.shape
    b, kb, t = anc.shape
    base = torch.arange(b, device=anc.device)[:, None, None] * kb
    lanes = (base + anc.to(torch.long)).reshape(bk, t)[:, t0:slot + 1]   # [BK, n]
    idx = lanes[None, :, :, None].expand(h, bk, lanes.shape[1], d)
    kg = torch.gather(_dequant(k, k_scale)[:, :, t0:slot + 1], 1, idx)   # [H, BK, n, D]
    vg = torch.gather(_dequant(v, v_scale)[:, :, t0:slot + 1], 1, idx)
    s = torch.einsum("rhd,hrtd->rht", q.to(torch.float32), kg) * scale
    w = torch.softmax(s, dim=-1)
    return torch.einsum("rht,hrtd->rhd", w, vg)


def _check(q, k, v, anc, slot, t0, k_scale, v_scale) -> None:
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"q must be [B*K, H, D] and k/v [H, B*K, T, D], got "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    bk, h, d = q.shape
    if tuple(k.shape[:2]) != (h, bk) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    t = k.shape[2]
    if anc.ndim != 3 or anc.shape[0] * anc.shape[1] != bk or anc.shape[2] != t:
        raise ValueError(f"anc must be [B, K, T] with B*K={bk}, T={t}, got "
                         f"{tuple(anc.shape)}")
    if anc.dtype != torch.int32:
        raise TypeError(f"anc must be int32, got {anc.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype not in _KIND or v.dtype != k.dtype:
        raise TypeError(f"k/v must be one of float32, bfloat16, int8; got "
                        f"{k.dtype} / {v.dtype}")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None) or quantized != (v_scale is not None):
        raise ValueError("k_scale/v_scale go with an int8 cache, and only with it")
    if quantized:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (h, bk, t, 1):
                raise ValueError(f"scales must be float32 [{h}, {bk}, {t}, 1], got "
                                 f"{s.dtype} {tuple(s.shape)}")
    if not 0 <= t0 <= slot < t:
        raise ValueError(f"need 0 <= t0 <= slot < T; got t0={t0}, slot={slot}, T={t}")
    tensors = [q, k, v, anc] + ([k_scale, v_scale] if quantized else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must be on one device")


def beam_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   anc: torch.Tensor, slot: int, *, scale: float, t0: int = 0,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ctx [B*K, H, D] f32 of one beam step for one layer (module
    docstring). CPU tensors: the plain version. CUDA tensors: one launch
    of kernel K3 (counted in `beam_attention.launches`) for H <= 32 heads
    of D <= 128 dims; the ancestry must hold beams 0..K-1 (not checked on
    the card: that would cost a device read per launch)."""
    _check(q, k, v, anc, slot, t0, k_scale, v_scale)
    if q.device.type == "cpu":
        return beam_attention_plain(q, k, v, anc, slot, scale=scale, t0=t0,
                                    k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bk, h, d = q.shape
    if h > MAX_HEADS or d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes at most {MAX_HEADS} heads of "
                         f"{MAX_HEAD_DIM} dims; got {h} x {d}")
    tensors = [q, k, v, anc] + ([k_scale, v_scale] if k_scale is not None else [])
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v, anc and the scales must be contiguous")
    out = torch.empty((bk, h, d), dtype=torch.float32, device=q.device)
    if bk == 0 or d == 0:
        return out
    lib = kernels.library("beam_attn")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.rgrg_beam_attention(
        q.data_ptr(), _KIND[q.dtype], k.data_ptr(), v.data_ptr(), _KIND[k.dtype],
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        anc.data_ptr(), out.data_ptr(), bk, h, k.shape[2], d, anc.shape[1],
        t0, slot, float(scale), stream)
    kernels.check(lib, code, "beam_attention")
    beam_attention.launches += 1
    return out


beam_attention.launches = 0

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
(csrc/beam_attn.cu) or raises. `plan` chooses the launch (beams and heads
per block, slots per staging chunk, threads); it is pure Python so that
the CPU tests pin its choices.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from rgrg_tpu_torch.ops import kernels

# the kernel's limits (csrc/beam_attn.cu)
MAX_HEADS = 32
MAX_HEAD_DIM = 128
MAX_BEAMS_PER_BLOCK = 8
MAX_PAIRS = 16            # (beam, head) pairs a block: a warp each
MAX_SLOTS = 32            # slots a chunk: a lane each
MAX_SMEM = 232_448        # 227 KB, a block's most on the H100
SMEM_BUDGET = 48 * 1024   # the plan's share a block: four or more blocks an SM

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ELEM = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}


class Plan(NamedTuple):
    """One launch of K3: a block per item's group of `beams` beams and group
    of `heads` heads, a warp per (beam, head) pair (`threads` = 32 x pairs),
    slots in chunks of `slots` (a lane each); `smem` bytes of dynamic shared
    memory a block."""
    beams: int
    heads: int
    slots: int
    threads: int
    smem: int


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(dtype: torch.dtype, d: int, beams: int, heads: int, slots: int) -> int:
    """A block's dynamic shared memory, as csrc/beam_attn.cu `make_layout`
    lays it out: a K and a V row of the block's heads per (beam, slot) of a
    chunk (padded so that consecutive rows fall in distinct banks; int8
    scales beside them), the f32 queries, and the softmax weights of a
    chunk."""
    elem = _ELEM[dtype]
    rs = _align16(d * elem)               # bytes of one head's row
    pitch = heads * rs + (16 if (heads * rs // 16) % 2 == 0 else 0)
    rows = slots * beams
    total = 2 * rows * pitch
    if dtype == torch.int8:
        total += _align16(2 * rows * heads * 4)
    return total + beams * heads * (_align16(rs // elem * 4) + 32 * 8)


@functools.lru_cache(maxsize=1024)
def plan(bk: int, k_beams: int, heads: int, d: int, t: int, kind: torch.dtype,
         sms: int) -> Plan:
    """The launch of K3 over bk = B*K lanes of K beams, `heads` heads of d
    dims, a cache of t slots of `kind` (the K/V dtype), on `sms` SMs. All
    beams of an item (up to 8) share a block, so each (lane, slot) row they
    name is read once; one head a block; chunks of 32 slots (a lane each),
    halved while a block's stage exceeds SMEM_BUDGET. At the beam path's
    shapes f32 and int8 get the fastest of the plans tools/k3_probe.py
    times; bf16 is 6% (slots 31, 59) to 20% (slot 2) slower than its
    fastest there, two heads a block (PERF.md). The grid is one block per
    (item, beam group, head group) whatever bk and sms are."""
    del bk, sms
    beams = min(k_beams, MAX_BEAMS_PER_BLOCK)
    hg = 1
    slots = min(MAX_SLOTS, t)
    while slots > 1 and smem_bytes(kind, d, beams, hg, slots) > SMEM_BUDGET:
        slots = (slots + 1) // 2
    return Plan(beams, hg, slots, 32 * beams * hg, smem_bytes(kind, d, beams, hg, slots))


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


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, anc: torch.Tensor,
           slot: int, scale: float, t0: int, k_scale: Optional[torch.Tensor],
           v_scale: Optional[torch.Tensor], out: torch.Tensor, p: Plan) -> torch.Tensor:
    """One launch of K3 with plan `p` writing out [B*K, H, D] f32 from
    checked, contiguous CUDA inputs (the kernel checks the plan). Counted
    in `beam_attention.launches`."""
    bk, h, d = q.shape
    lib = kernels.library("beam_attn")
    code = lib.rgrg_beam_attention(
        q.data_ptr(), _KIND[q.dtype], k.data_ptr(), v.data_ptr(), _KIND[k.dtype],
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        anc.data_ptr(), out.data_ptr(), bk, h, k.shape[2], d, anc.shape[1],
        t0, slot, float(scale), p.beams, p.heads, p.slots,
        kernels.raw_stream(q.get_device()))
    kernels.check(lib, code, "beam_attention")
    beam_attention.launches += 1
    return out


def beam_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   anc: torch.Tensor, slot: int, *, scale: float, t0: int = 0,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ctx [B*K, H, D] f32 of one beam step for one layer (module
    docstring). CPU tensors: the plain version. CUDA tensors: one launch
    of kernel K3 (counted in `beam_attention.launches`) for H <= 32 heads
    of D <= 128 dims, planned by `plan`; the ancestry must hold beams
    0..K-1 (not checked on the card: that would cost a device read per
    launch). Allocates only the output; `out` (a contiguous f32
    [B*K, H, D] on q's device) receives it instead, and is returned. It
    has no backward: with grad enabled, an input that requires grad
    raises rather than getting a result cut off from the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, k_scale, v_scale)):
        raise RuntimeError("beam_attention has no backward; call it under "
                           "torch.no_grad() or with inputs that need no grad")
    _check(q, k, v, anc, slot, t0, k_scale, v_scale)
    bk, h, d = q.shape
    if out is not None and (out.dtype != torch.float32 or tuple(out.shape) != (bk, h, d)
                            or out.device != q.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 [{bk}, {h}, {d}] on "
                         f"{q.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if q.device.type == "cpu":
        ctx = beam_attention_plain(q, k, v, anc, slot, scale=scale, t0=t0,
                                   k_scale=k_scale, v_scale=v_scale)
        return ctx if out is None else out.copy_(ctx)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if h > MAX_HEADS or d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes at most {MAX_HEADS} heads of "
                         f"{MAX_HEAD_DIM} dims; got {h} x {d}")
    tensors = [q, k, v, anc] + ([k_scale, v_scale] if k_scale is not None else [])
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v, anc and the scales must be contiguous")
    if out is None:
        out = torch.empty((bk, h, d), dtype=torch.float32, device=q.device)
    if bk == 0 or d == 0:
        return out
    p = plan(bk, anc.shape[1], h, d, k.shape[2], k.dtype,
             kernels.sm_count(q.get_device()))
    return launch(q, k, v, anc, slot, scale, t0, k_scale, v_scale, out, p)


beam_attention.launches = 0

"""Routed experts with static shapes and no host read (models/moonlight.py).

One layer of DeepSeek-V3's `noaux_tc` mixture of experts:

  - route: sigmoid scores of the router in f32; the top-k of the scores
    plus a correction bias chooses the experts (the bias decides the
    choice only); the chosen scores, renormalised to sum to one and
    scaled, weight them;
  - dispatch: the N x k choices flattened and sorted by expert (stable),
    the per-expert group ends found in the sorted ids
    (`torch.searchsorted`: `torch.bincount` reads its input's maximum on
    the host on the card), the rows gathered in sorted order;
  - experts: SwiGLU, gate|up as one product and down as another, each a
    grouped product over the experts' row groups (`grouped_mm`);
  - combine: the expert rows put back in choice order (a permutation, so
    no accumulation order to vary between runs) and summed with their
    weights in f32.

Every shape depends on N and k only, so a step that calls this can be
captured as a CUDA graph. While it runs, per expert layer, the rows each
expert took and the calls in which it took any are added on the device
into `expert_counters` (read by utils.logging.counters).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from rgrg_tpu_torch.utils.logging import span

# (device, layers, experts) -> [2, layers, experts] int64: rows, then steps
_COUNTERS: Dict[Tuple[str, int, int], torch.Tensor] = {}


def expert_counters(device: torch.device, layers: int, experts: int) -> torch.Tensor:
    """The device counters of a model's expert layers, [2, layers, experts]
    int64: [0] the rows each expert took, [1] the calls (decode steps and
    prefills) in which it took at least one. Made (zero) on first use; a step being captured must
    find them made (its eager warm-up step makes them)."""
    key = (str(device), layers, experts)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros((2, layers, experts), dtype=torch.int64, device=device)
    return _COUNTERS[key]


def read_counters() -> Dict[str, list]:
    """`moe.expert_rows` and `moe.expert_steps` ([layers][experts] ints),
    summed over the devices a model of one shape ran on (a process runs one
    such model); reads the device (never call it inside a step)."""
    if not _COUNTERS:
        return {}
    total = sum(c.cpu() for c in _COUNTERS.values())
    return {"moe.expert_rows": total[0].tolist(), "moe.expert_steps": total[1].tolist()}


def route(m: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, top_k: int,
          scale: float, norm_topk: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """m [N, D], router [E, D], bias [E] -> (choice [N, k] int64, weight
    [N, k] f32)."""
    with span("moe.route"):
        s = torch.sigmoid(m.float() @ router.float().T)
        choice = torch.topk(s + bias.float(), top_k, dim=-1).indices
        w = torch.gather(s, 1, choice)
        if norm_topk:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return choice, w * scale


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """x [M, K] rows grouped in order, w [G, K, N], ends [G] int32 each
    group's end row -> [M, N]: each group's rows times its matrix
    (`torch._grouped_mm`). On the card only in bfloat16: for other dtypes
    torch loops over the groups reading their ends on the host, which a
    captured step cannot do."""
    if x.is_cuda and x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{x.dtype} experts on CUDA are not implemented for the Moonlight (MLA/MoE) "
            "decoder: give it bfloat16 weights (decoder_dtype)")
    return torch._grouped_mm(x, w, offs=ends)


def swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """down(silu(x gate) * (x up)) with gate|up one [D, 2I] matrix."""
    h = x @ gate_up
    i = h.shape[-1] // 2
    return (F.silu(h[..., :i]) * h[..., i:]) @ down


def moe(m: torch.Tensor, p: Dict[str, torch.Tensor], top_k: int, scale: float,
        norm_topk: bool, counters: torch.Tensor = None, layer: int = 0) -> torch.Tensor:
    """One expert layer on m [N, D]: the routed experts' weighted sum plus
    the shared experts, [N, D] in m's dtype. p: "router" [E, D], "bias"
    [E], "gate_up" [E, D, 2I], "down" [E, I, D], "shared_gate_up" [D, 2I_s],
    "shared_down" [I_s, D]. counters: expert_counters' tensor, whose
    `layer` row this call adds to."""
    n, d = m.shape
    e = p["router"].shape[0]
    choice, weight = route(m, p["router"], p["bias"], top_k, scale, norm_topk)
    with span("moe.experts"):
        ids, order = torch.sort(choice.reshape(-1), stable=True)
        ends = torch.searchsorted(ids, torch.arange(1, e + 1, device=m.device), out_int32=True)
        xs = m.index_select(0, order // top_k)
        h = grouped_mm(xs, p["gate_up"], ends)
        i = h.shape[1] // 2
        y = grouped_mm(F.silu(h[:, :i]) * h[:, i:], p["down"], ends)
        back = torch.empty_like(y).index_copy_(0, order, y)
        out = (back.view(n, top_k, d).float() * weight[..., None]).sum(1)
        out += swiglu(m, p["shared_gate_up"], p["shared_down"]).float()
        if counters is not None:
            counts = torch.diff(ends, prepend=ends.new_zeros(1))
            counters[0, layer].add_(counts)
            counters[1, layer].add_(counts > 0)
        return out.to(m.dtype)

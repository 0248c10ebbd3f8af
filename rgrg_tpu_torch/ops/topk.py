"""Top-k with the JAX package's tie order.

jax.lax.top_k breaks ties by the lower index, and the detector's proposal
order and beam search's candidate order both depend on it; torch.topk
promises no tie order.
"""

from __future__ import annotations

import torch


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last dim in descending order, ties broken by the
    lower index (lax.top_k's order). Returns (values in x's dtype, int64
    indices); k is capped at the dim's size.

    Every entry gets a distinct int64 key: an order-preserving int32 image
    of its f32 value in the high half (-0.0 just below +0.0, as lax.top_k
    orders them) and the reversed index in the low half, so one torch.topk
    over the keys is exact without sorting the whole row."""
    bits = x.to(torch.float32).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    n = x.shape[-1]
    reverse = (n - 1) - torch.arange(n, dtype=torch.int64, device=x.device)
    idx = torch.topk(ordered * (1 << 32) + reverse, min(k, n), dim=-1).indices
    return torch.gather(x, -1, idx), idx

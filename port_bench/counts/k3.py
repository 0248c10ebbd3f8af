"""Bytes and operations of kernel K3 (`csrc/beam_attn.cu`, ancestry-masked
beam attention) a launch needs, from the inputs it is handed.

A launch reads, for every item and cache slot from t0 to the written slot,
the K and V rows of the lanes the ancestry table names there (a row that
several beams share is read once), their int8 scales, each lane's query,
the table itself, and writes each lane's f32 context:

    bytes = rows x heads x (2 x head_dim x elem + scales)
          + lanes x heads x head_dim x (q elem + 4) + the table's slots
    flops = 4 x head_dim x heads x lanes x slots

`rows` is counted from the table as recorded at each step. The bound is
the larger of bytes / HBM bandwidth and flops / f32 peak.
"""

from __future__ import annotations

from typing import Dict, List

import torch

ELEM = {"torch.int8": 1, "torch.bfloat16": 2, "torch.float16": 2, "torch.float32": 4}


def step_counts(step: Dict) -> Dict[str, float]:
    """One recorded beam step (port_bench.drivers.serve_pipelined.AncestryTap):
    bytes and flops of one of its launches."""
    anc = step["anc"]                                   # [B, K, T] int32
    t0, slot = step["t0"], step["slot"]
    b, k, _ = anc.shape
    names = torch.sort(anc[:, :, t0:slot + 1], dim=1).values
    rows = int(b * (slot + 1 - t0) + (names[:, 1:] != names[:, :-1]).sum())
    heads, d = step["heads"], step["head_dim"]
    elem = ELEM[step["cache_dtype"]]
    scales = 8 if elem == 1 else 0
    lanes = step["lanes"]
    nbytes = (rows * heads * (2 * d * elem + scales)
              + lanes * heads * d * (step["q_bytes"] + 4) + b * k * (slot + 1) * 4)
    flops = 4.0 * d * heads * lanes * (slot + 1 - t0)
    return {"bytes": float(nbytes), "flops": flops}


def bound_seconds(steps: List[Dict], peaks: Dict) -> float:
    """The least time the recorded launches could take on the card."""
    total = 0.0
    for step in steps:
        c = step_counts(step)
        total += step["launches"] * max(c["bytes"] / peaks["hbm_bytes_per_s"],
                                        c["flops"] / peaks["f32_flops"])
    return total

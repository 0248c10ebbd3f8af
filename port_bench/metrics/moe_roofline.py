"""moe_roofline: the least time the expert layers' traced work could take
(`port_bench/counts/moe.py`: every expert's three matrices once in each
step in which it took a row, the routed rows gathered and written, over
the card's HBM bandwidth) over the device time of the expert layers'
kernels in the trace, in %: each layer's dispatch, grouped products and
combine, found by launch order around its pair of grouped products
(`moe.expert_kernels`). Nothing to read where the program keeps no expert
counters or no such kernel ran."""

from typing import Dict, Optional

from port_bench.counts import moe


def read(rec: Dict) -> Optional[float]:
    trace, peaks = rec["trace"], rec["peaks"]
    counters = trace.get("counters") or {}
    if not peaks or "moe.expert_steps" not in counters:
        return None
    spent = moe.expert_seconds(trace["events"])
    if spent <= 0:
        return None
    nbytes = moe.expert_bytes(rec["config"], counters["moe.expert_rows"],
                              counters["moe.expert_steps"])
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / spent

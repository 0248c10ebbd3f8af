"""k3_roofline: the least time kernel K3 (`beam_attn_kernel`) could take on
the traced slice's launches (`port_bench/counts/k3.py`, from the ancestry
recorded at each beam step) over the device time of its launches in the
trace, in %. Nothing to read where no beam step ran."""

from typing import Dict, Optional

from port_bench.counts import k3


def read(rec: Dict) -> Optional[float]:
    trace, peaks = rec["trace"], rec["peaks"]
    steps = trace.get("ancestry") or []
    spent = sum(e - s for n, s, e in trace["events"] if "beam_attn_kernel" in n) * 1e-6
    if not steps or not peaks or spent <= 0:
        return None
    return 100.0 * k3.bound_seconds(steps, peaks) / spent

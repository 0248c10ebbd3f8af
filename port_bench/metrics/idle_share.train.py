"""idle_share.train: the share of the traced training mini-steps in which
no operation ran on the card: 1 - (union of the device intervals in the
profiler's trace) / (the slice's wall time), in %."""

from typing import Dict, Optional


def read(rec: Dict) -> Optional[float]:
    slice_s = rec["trace"]["slice_s"]
    if slice_s <= 0 or not rec["trace"]["events"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / slice_s)

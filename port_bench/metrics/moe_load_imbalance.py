"""moe_load_imbalance: per expert layer, the rows of its busiest expert
over the mean rows of its experts in the window (`moe.expert_rows`, the
program's device counters), the median over the expert layers. 1 is an
even load. Nothing to read where the program keeps no expert counters."""

import statistics
from typing import Dict, Optional


def read(rec: Dict) -> Optional[float]:
    rows = rec["window"]["counters"].get("moe.expert_rows")
    if not rows:
        return None
    ratios = [max(r) / (sum(r) / len(r)) for r in rows if sum(r) > 0]
    return statistics.median(ratios) if ratios else None

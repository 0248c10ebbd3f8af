"""train_mfu: the operations the window's mini-steps need
(`port_bench/counts/train.py`, K2's backward as the taps it needs) over
the window's seconds, the cell's chips and one card's published float32
peak (TF32 off), in %."""

from typing import Dict, Optional

from port_bench.counts import train


def read(rec: Dict) -> Optional[float]:
    peaks, win = rec["peaks"], rec["window"]
    if not peaks or not win.get("steps"):
        return None
    flops = win["steps"] * train.step_flops(rec["config"], win["mean_tokens"])["total"]
    return 100.0 * flops / (win["window_s"] * peaks["f32_flops"] * rec["chips"])

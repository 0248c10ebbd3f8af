"""decode_ms_per_step: host milliseconds inside the model's decode entries
(the benchmark's span around `detect_and_decode`,
`decode_selected_cascade` and `decode_selected`) over the window, per
decode step the program counted (`greedy_generate.steps` +
`beam_generate.steps`). The fused entry also dispatches its batch's
detector, a few ms of a batch."""

from typing import Dict, Optional


def read(rec: Dict) -> Optional[float]:
    win = rec["window"]
    steps = win["counters"]["greedy_generate.steps"] + win["counters"]["beam_generate.steps"]
    if not steps:
        return None
    return 1000.0 * win["spans"]["decode"] / steps

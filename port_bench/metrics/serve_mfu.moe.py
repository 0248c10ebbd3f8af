"""serve_mfu.moe: the operations the window's served batches need with the
Moonlight decoder (`port_bench/counts/moe.py`: resize and detector as
counts/serve.py counts them, each decoded row's prefill and every beam
lane's steps, 2 x active parameters plus absorbed attention over the
cache at that step) over the window's seconds and the card's published
bf16 dense peak, in %."""

from typing import Dict, Optional

from port_bench.counts import moe


def read(rec: Dict) -> Optional[float]:
    peaks = rec["peaks"]
    if not peaks:
        return None
    win = rec["window"]
    flops = moe.window_flops(rec["config"], rec["traffic"], win["work"])
    return 100.0 * flops / (win["window_s"] * peaks["bf16_flops"])

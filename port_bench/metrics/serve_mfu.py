"""serve_mfu: the operations the window's served batches need
(`port_bench/counts/serve.py`: resize, detector, prefill and every decode
step's lanes with attention over the cache at that step, LM head) over
the window's seconds and the card's published bf16 dense peak, in %."""

from typing import Dict, Optional

from port_bench.counts import serve


def read(rec: Dict) -> Optional[float]:
    peaks = rec["peaks"]
    if not peaks:
        return None
    win = rec["window"]
    flops = serve.window_flops(rec["config"], rec["traffic"], win["work"])
    return 100.0 * flops / (win["window_s"] * peaks["bf16_flops"])

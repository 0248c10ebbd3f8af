"""The readings that the limits of a served cell are set from: the
program's numbers and its control's, seed after seed, in one process.

    python3 port_bench/calibrate.py --workload serve-beam4-b16 --seeds 11 12 13 --seconds 8

For each seed: the cell's set-up, a window of `--seconds` (long enough to
serve the whole image pool once), then the reference's judgement of the
program and of the control (the reference one precision below the
configuration's, in the program's place), and each side's verdict
against the cell's limits as a run reaches it (the control's has to be
false). `--fault` plants one of
`faults.py`'s faults in the program instead. Prints one JSON line a seed and writes
them all to `chiprun_out/calibrate_<workload>.json`. The benchmark's runs
do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench.faults import FAULTS  # noqa: E402
from port_bench.run import ROOT, judge, load_json, load_module, resolve  # noqa: E402


def fault_args(fault, traffic):
    return (traffic["num_beams"],) if fault == "token" else ()


def readings(driver_cls, cfg, traffic, limits, seed, seconds, device, fault=None):
    """One seed: {"program": numbers, "control": numbers}, each side's
    verdict against the cell's limits (`run.judge`, as a run decides
    `correct`) and timings; with `fault`, the program runs with that
    fault planted (faults.py)."""
    t0 = time.perf_counter()
    drv = driver_cls(cfg, traffic, seed, device)
    with FAULTS[fault](*fault_args(fault, traffic)) if fault else contextlib.nullcontext():
        drv.setup()
        t1 = time.perf_counter()
        win = drv.window(seconds)
        drv.finish()
    t2 = time.perf_counter()
    res = drv.check(control=fault is None)
    res["correct"] = {side: judge(numbers, limits)[0] for side, numbers in res.items()}
    res.update(seed=seed, setup_s=t1 - t0, window_s=win["window_s"],
               e2e=win["e2e"], check_s=time.perf_counter() - t2)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None,
                    help="plant this fault in the program (the readings a limit's upper end "
                         "is set from); no control then")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = resolve(load_json(ROOT, "BENCHMARK.json"), args.workload)
    cls = load_module(c["driver"]).Driver
    out = []
    for seed in args.seeds:
        r = readings(cls, c["config"], c["traffic"], c["limits"], seed, args.seconds,
                     torch.device("cuda"), args.fault)
        print(json.dumps(dict(r, fault=args.fault)), flush=True)
        out.append(r)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    tag = args.workload + ("_" + args.fault if args.fault else "")
    with open(os.path.join(ROOT, "chiprun_out", f"calibrate_{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell of the port's benchmark.

    python3 port_bench/run.py --workload serve-beam4-b16 --seed 7 --seconds 30 --trace 0

Everything about a cell is data that this file finds by name:
`BENCHMARK.json` names the cell's configuration and traffic;
`port_bench/configs/<config>.json` holds the model's sizes and precision,
`port_bench/traffic/<traffic>.json` the traffic's parameters and the
driver that runs them (`port_bench/drivers/<driver>.py`),
`port_bench/limits/<cell>.json` the limit of each number that decides
`correct`, and `port_bench/metrics/<metric>.py` reads one per-layer metric
from a traced run's records.

A run sets up (kernel build, weights and inputs from the seed, warm-up),
measures for `--seconds`, with `--trace 1` profiles a short steady slice
after the window, then stops the program, frees its state and has the
plain reference judge what the window produced. The last line of standard
output is the result as one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key. A run without a card, with fewer cards than the cell asks for,
or that finds JAX or the JAX package loaded, exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "port_bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "rgrg_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str):
    """A benchmark file loaded by its path (names may hold dots)."""
    name = "port_bench_" + os.path.relpath(path, BENCH).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: Dict, workload: str, root: str = ROOT) -> Dict:
    """The cell `workload` of BENCHMARK.json with its files loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    base = os.path.join(root, "port_bench")
    traffic = load_json(base, "traffic", w["traffic"] + ".json")
    return {"cell": w, "config": load_json(base, "configs", w["config"] + ".json"),
            "traffic": traffic, "limits": load_json(base, "limits", workload + ".json"),
            "driver": os.path.join(base, "drivers", traffic["driver"] + ".py")}


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port's runs must not
    load, compared whole (rgrg_tpu_torch is not rgrg_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_union(events: List[Tuple[str, float, float]]) -> Tuple[float, List[Tuple[str, float]]]:
    """Seconds covered by device intervals (us), and the idle gaps between
    them, each named by the operation that ends it."""
    spans = sorted((s, e, n) for n, s, e in events)
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, n in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append(("before " + n, (s - cur_e) * 1e-6))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6, gaps


def breakdown(events) -> Dict:
    by_op: Dict[str, float] = {}
    for n, s, e in events:
        by_op[n] = by_op.get(n, 0.0) + (e - s) * 1e-6
    _, gaps = device_union(events)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], v] for n, v in top],
            "idle_gaps": [[n[:120], v] for n, v in sorted(gaps, key=lambda g: -g[1])[:10]]}


def per_layer(bench: Dict, workload: str, rec: Dict) -> Dict:
    out = {}
    for m in bench["per_layer"]:
        if not applies(m, workload):
            continue
        value = load_module(os.path.join(BENCH, "metrics", m["name"] + ".py")).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: Dict, limits: Dict) -> Tuple[bool, Dict]:
    """Each number beside its limit; correct when every one is within."""
    checks = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def result_line(correct: bool, win: Dict, metrics: Dict, device: Dict, checks: Dict,
                breakdown_: Optional[Dict] = None) -> Dict:
    """The result's keys in the contract's order, the numbers compared last."""
    out = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
           "metrics": metrics, "device": device}
    if breakdown_ is not None:
        out["breakdown"] = breakdown_
    out["checks"] = checks
    return out


def peaks_for(kind: str) -> Optional[Dict]:
    return load_json(BENCH, "counts", "peaks.json").get(kind)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    c = resolve(bench, args.workload)
    # every build and kernel cache at a fixed path inside the checkout
    cache = os.path.join(ROOT, "build", "port_bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"

    import torch
    chips = c["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # the reference computes in float32 proper; the configurations state
    # their own precisions, none of them TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    drv = load_module(c["driver"]).Driver(c["config"], c["traffic"], args.seed,
                                          torch.device("cuda"))
    drv.setup()
    # the reference's work in set-up (a driver's readout of what the check
    # compares, or a calibration over the inputs) is not the program's
    setup_s = time.perf_counter() - T_START - getattr(drv, "readout_s", 0.0)
    win = drv.window(args.seconds)
    traced = drv.trace() if args.trace else None
    drv.finish()
    numbers = drv.check()["program"]

    kind = torch.cuda.get_device_name(0)
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": win["memory_peak_bytes"]}
    # one reading of the peak, under a metric per kind of cell (their bounds differ)
    peak = win["memory_peak_bytes"] / 1e9
    e2e = dict(win["e2e"], setup_s=setup_s, **{m["name"]: peak for m in bench["end_to_end"]
                                                if m["name"].startswith("peak_gb")})
    trace_breakdown = None
    if traced is None:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, args.workload)}
    else:
        busy, _ = device_union(traced["events"])
        device.update(busy_s=busy, window_s=traced["slice_s"])
        rec = {"config": c["config"], "traffic": c["traffic"], "window": win, "chips": chips,
               "trace": traced, "busy_s": busy, "peaks": peaks_for(kind)}
        metrics = per_layer(bench, args.workload, rec)
        trace_breakdown = breakdown(traced["events"])
    ok, checks = judge(numbers, c["limits"])

    found = forbidden_modules()
    if found:
        print("loaded modules the port's benchmark must not load: " + ", ".join(found),
              file=sys.stderr)
        return 3
    result = result_line(ok, win, metrics, device, checks, trace_breakdown)
    for name, ch in checks.items():
        print(f"check {name}: {ch['value']} (limit {ch['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run metrics and profiles.

- `MetricWriter` appends scalars to `<run_dir>/metrics.jsonl` (one JSON
  object a line: step, wall time, the flattened scalars) and writes the
  run's config beside it. No tensorboard: the card's machine has none.
- `trace(log_dir)` profiles a block with torch.profiler and writes a Chrome
  trace (`<host>_<pid>.<ns>.pt.trace.json`, viewable in Perfetto or
  chrome://tracing) to `log_dir`: the counterpart of the JAX package's
  jax.profiler trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Mapping, Optional


class MetricWriter:
    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def write_scalars(self, step: int, scalars: Mapping[str, Any]) -> None:
        rec = {"step": int(step), "time": time.time(), **_flatten(scalars)}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def write_config(self, config: Any) -> None:
        with open(os.path.join(self.run_dir, "run_config.txt"), "w") as f:
            f.write(repr(config))

    def close(self) -> None:
        self.jsonl.close()


def _flatten(d: Mapping[str, Any], prefix: str = "") -> Dict[str, float]:
    """Nested mappings -> {"a/b": float}; values that are not numbers are
    left out."""
    out: Dict[str, float] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            try:
                out[key] = float(v)
            except (TypeError, ValueError):
                pass
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler trace of the block, written to `log_dir`; a no-op when
    log_dir is None. CPU activity always, the card's kernels and copies too
    whenever CUDA is available."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir),
                 acc_events=True):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()

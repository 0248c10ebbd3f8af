"""Run metrics: `MetricWriter` appends scalars to `<run_dir>/metrics.jsonl`
(one JSON object a line: step, wall time, the flattened scalars) and writes
the run's config beside it. No tensorboard: the card's machine has none."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Mapping


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

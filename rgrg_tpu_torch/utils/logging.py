"""Run metrics and profiles.

- `MetricWriter` appends scalars to `<run_dir>/metrics.jsonl` (one JSON
  object a line: step, wall time, the flattened scalars) and writes the
  run's config beside it. No tensorboard: the card's machine has none.
- `span(name, batch=None)` times a block of host code for the span
  recorder (`spans_on` / `spans_off` / `drain_spans`). Off, the default, it
  returns one shared no-op context: no clock read, no allocation, no lock.
  On, each span keeps its name, thread, batch id (given, or its parent's),
  parent (the innermost open span of its thread) and start and end in
  `time.time_ns()`, the Unix clock on which torch.profiler times its host
  events (`device_clock` joins its device times to it). A span never
  reads a device value and adds no synchronisation: it measures host time
  only. The buffer is bounded; spans past `capacity` are dropped and
  counted. `idle_by_span` splits a card's idle time by the innermost span
  open on a thread.
- `trace(log_dir)` profiles a block with torch.profiler and writes a Chrome
  trace (`<host>_<pid>.<ns>.pt.trace.json`, viewable in Perfetto or
  chrome://tracing) to `log_dir`: the counterpart of the JAX package's
  jax.profiler trace. It records spans for its block and writes them into
  the trace, one track per thread, on the kernels' time base (the
  kernels' launches measure the profile's clock offset and its drift),
  with the port's counters over the block and the card's idle time by
  span under the top-level key "rgrg".
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import socket
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple


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


# -------------------------------------------------------------------- spans

class _Off:
    """The context `span()` returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.spans: List[Tuple] = []   # (id, parent, name, thread, batch, start ns, end ns)
        self.dropped = 0
        self.ids = itertools.count(1)
        self.lock = threading.Lock()

    def add(self, rec: Tuple) -> None:
        with self.lock:
            if len(self.spans) < self.capacity:
                self.spans.append(rec)
            else:
                self.dropped += 1


_recorder: Optional[_Recorder] = None
_local = threading.local()


class _Span:
    __slots__ = ("rec", "name", "batch", "id", "parent", "stack", "start")

    def __init__(self, rec: _Recorder, name: str, batch: Optional[int]):
        self.rec, self.name, self.batch = rec, name, batch

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else 0
        if self.batch is None and top is not None:
            self.batch = top.batch
        self.id = next(self.rec.ids)
        self.stack = stack
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        stack = self.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:   # a generator closed while another span was open
            stack.remove(self)
        self.rec.add((self.id, self.parent, self.name, threading.current_thread().name,
                      self.batch, self.start, end))
        return False


def span(name: str, batch: Optional[int] = None):
    """A context that records the host time of its block as a span while
    the recorder is on (`spans_on`); the shared no-op context otherwise.
    batch: the id of the batch the work belongs to (None: the enclosing
    span's)."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(rec, name, batch)


def spans_on(capacity: int = 1 << 20) -> None:
    """Starts recording spans into a fresh buffer of `capacity` spans."""
    global _recorder
    _recorder = _Recorder(capacity)


def drain_spans() -> Dict[str, Any]:
    """The spans closed since recording started or since the last drain,
    oldest first, and the count dropped past the buffer's bound; empties
    the buffer. Each span: {"id", "parent" (0: none), "name", "thread",
    "batch", "start_ns", "end_ns"}."""
    rec = _recorder
    if rec is None:
        return {"spans": [], "dropped": 0}
    with rec.lock:
        spans, dropped = rec.spans, rec.dropped
        rec.spans, rec.dropped = [], 0
    keys = ("id", "parent", "name", "thread", "batch", "start_ns", "end_ns")
    return {"spans": [dict(zip(keys, s)) for s in spans], "dropped": dropped}


def spans_off() -> Dict[str, Any]:
    """Stops recording; returns what `drain_spans` would."""
    global _recorder
    out = drain_spans()
    _recorder = None
    return out


def span_segments(spans: Iterable[Mapping], thread: str) -> List[Tuple[int, int, str]]:
    """The timeline of `thread`'s innermost open span: (start ns, end ns,
    name) pieces in time order, leaving out time in which none was open."""
    edges = []
    for n, sp in enumerate(s for s in spans
                           if s["thread"] == thread and s["end_ns"] > s["start_ns"]):
        # at one instant, ends go first and the longer of two starts (the
        # outer span) opens first
        edges += [(sp["start_ns"], 1, -sp["end_ns"], n, sp["name"]),
                  (sp["end_ns"], 0, 0, n, sp["name"])]
    edges.sort()
    out, open_ = [], []   # open_: (index, name), innermost last
    t_prev = None
    for t, is_start, _, n, name in edges:
        if open_ and t > t_prev:
            out.append((t_prev, t, open_[-1][1]))
        if is_start:
            open_.append((n, name))
        else:
            open_.remove((n, name))
        t_prev = t
    return out


def idle_by_span(spans: Iterable[Mapping], busy: Sequence[Tuple[int, int]],
                 start_ns: int, end_ns: int, thread: str = "MainThread") -> Dict[str, float]:
    """Seconds of [start_ns, end_ns] in which no device interval of `busy`
    ((start ns, end ns), on the spans' clock) runs, by the innermost span
    open on `thread` at the time; "(none)" where none was open. The parts
    add up to the idle time."""
    idle, t = [], start_ns
    for s, e in sorted(busy):
        if s > t:
            idle.append((t, min(s, end_ns)))
        t = max(t, e)
        if t >= end_ns:
            break
    if t < end_ns:
        idle.append((t, end_ns))
    out: Dict[str, float] = {}
    segs, j = span_segments(spans, thread), 0
    for g0, g1 in idle:
        if g1 <= g0:
            continue
        covered = 0
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            part = min(g1, segs[k][1]) - max(g0, segs[k][0])
            out[segs[k][2]] = out.get(segs[k][2], 0.0) + part * 1e-9
            covered += part
            k += 1
        out["(none)"] = out.get("(none)", 0.0) + (g1 - g0 - covered) * 1e-9
    return out


_COUNTERS = (("rgrg_tpu_torch.decode.greedy", "greedy_generate", ("prefills", "steps", "rows")),
             ("rgrg_tpu_torch.decode.beam", "beam_generate",
              ("steps", "rows", "graph_steps", "graph_captures")),
             ("rgrg_tpu_torch.serving", "generate_reports_pipelined", ("rows_selected",)),
             ("rgrg_tpu_torch.ops.nms", "nms_keep_mask", ("launches",)),
             ("rgrg_tpu_torch.ops.roi_align", "roi_align", ("launches",)),
             ("rgrg_tpu_torch.ops.beam_attn", "beam_attention", ("launches",)),
             ("rgrg_tpu_torch.ops.dense_wint8", "dense_wint8", ("launches",)))


def counters() -> Dict[str, int]:
    """The port's host counters (decode steps and rows, the rows the
    pipelined server selected, the kernels' launches) of the modules
    loaded so far, as "function.counter"."""
    out = {}
    for module, fn, names in _COUNTERS:
        mod = sys.modules.get(module)
        if mod is not None:
            f = getattr(mod, fn)
            out.update({f"{fn}.{n}": getattr(f, n) for n in names})
    return out


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_SPAN_TID = 1 << 30   # the span tracks' thread ids, clear of the host's


def device_clock(device: Iterable[Tuple[int, int, Optional[int]]], launches: Mapping[int, int],
                 max_drift: float = 0.01) -> Callable[[int], int]:
    """Host ns -> a profile's device ns. device: the profile's device
    operations as (start ns, end ns, correlation id); launches: the start
    ns of the host call that launched each kernel, by correlation id (the
    runtime's events, which the profiler times on the host's clock).

    The profiler's device times are off the host's clock by an offset that
    differs between profiles and drifts under load (on an H100 80GB HBM3
    up to 0.8% of the elapsed time, either way, and not steadily). No
    kernel starts before its launch began, so each bounds the offset from
    above at its launch; the map takes the least offset that every launch
    allows if the offset moves by at most `max_drift` of the time between
    them. Where a kernel was launched onto an idle card the bound is tight
    to a few microseconds. Without launches the map is the identity."""
    anchors = sorted((launches[c], start - launches[c]) for start, _, c in device
                     if c in launches)
    if not anchors:
        return lambda t: t
    at = [t for t, _ in anchors]
    bound = [u for _, u in anchors]
    for k in range(1, len(bound)):
        bound[k] = min(bound[k], bound[k - 1] + max_drift * (at[k] - at[k - 1]))
    for k in range(len(bound) - 2, -1, -1):
        bound[k] = min(bound[k], bound[k + 1] + max_drift * (at[k + 1] - at[k]))

    def to_device(t: int) -> int:
        k = bisect.bisect(at, t)
        near = [bound[k - 1] + max_drift * (t - at[k - 1])] if k else []
        if k < len(at):
            near.append(bound[k] + max_drift * (at[k] - t))
        return t + round(min(near))
    return to_device


def add_spans_to_chrome_trace(path: str, recorded: Mapping, start_ns: int, end_ns: int,
                              counters_: Mapping[str, int]) -> Dict[str, Any]:
    """Writes `recorded` spans (`spans_off()`'s result) into the Chrome
    trace at `path`, one track per thread, on the device events' time base
    (`device_clock`, from the trace's kernels and their launches; its
    offsets at the block's ends are kept as "clock_offset_us"), and under
    the key "rgrg" the dropped count, `counters_`, and, when the trace
    holds device activity, the card's idle seconds over [start_ns,
    end_ns] by the main thread's innermost span. Returns the "rgrg"
    entry."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    base = doc.get("baseTimeNanoseconds", 0)

    def ns(us: float) -> int:
        return base + int(us * 1000)

    device = [(ns(e["ts"]), ns(e["ts"] + e.get("dur", 0)), e.get("args", {}).get("correlation"))
              for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    launches = {e["args"]["correlation"]: ns(e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime" and "aunch" in e.get("name", "")
                and "correlation" in e.get("args", {})}
    to_device = device_clock(device, launches)
    spans = [dict(sp, start_ns=to_device(sp["start_ns"]), end_ns=to_device(sp["end_ns"]))
             for sp in recorded["spans"]]
    pid = os.getpid()
    tids: Dict[str, int] = {}
    for sp in spans:
        if sp["thread"] not in tids:
            tids[sp["thread"]] = tid = _SPAN_TID + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": "spans: " + sp["thread"]}})
        events.append({"ph": "X", "cat": "rgrg_span", "name": sp["name"], "pid": pid,
                       "tid": tids[sp["thread"]], "ts": (sp["start_ns"] - base) / 1000,
                       "dur": (sp["end_ns"] - sp["start_ns"]) / 1000,
                       "args": {"batch": sp["batch"], "id": sp["id"], "parent": sp["parent"]}})
    summary = {"spans_dropped": recorded["dropped"], "counters": dict(counters_),
               "clock_offset_us": [(to_device(t) - t) / 1000 for t in (start_ns, end_ns)]}
    if device:
        summary["idle_by_span_s"] = idle_by_span(
            spans, [(s, e) for s, e, _ in device], to_device(start_ns), to_device(end_ns),
            threading.main_thread().name)
    doc["rgrg"] = summary
    with open(path, "w") as f:
        json.dump(doc, f)
    return summary


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler trace of the block, written to `log_dir`; a no-op when
    log_dir is None. CPU activity always, the card's kernels and copies too
    whenever CUDA is available. The block's spans go into the same trace
    on the kernels' time base (`add_spans_to_chrome_trace`), with the
    counters' change over it."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    block: Dict[str, Any] = {}

    def ready(prof) -> None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                     f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        add_spans_to_chrome_trace(path, block["spans"], block["start"], block["end"],
                                  block["counters"])

    before = counters()
    with profile(activities=activities, on_trace_ready=ready, acc_events=True):
        spans_on()
        block["start"] = time.time_ns()
        try:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            block["end"] = time.time_ns()
            block["spans"] = spans_off()
            after = counters()
            block["counters"] = {k: v - before.get(k, 0) for k, v in after.items()}

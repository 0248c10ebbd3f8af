"""The port's span recorder and counters (`utils/logging.py`).

- Off (the default), `span()` is one shared no-op context and reads no
  clock.
- On, it records names, parents, threads and batch ids, with nesting kept
  per thread, in a bounded buffer that drops and counts what overflows.
- A tiny `generate_reports_pipelined` run at greedy and at beam 2 on the
  CPU: each batch's spans share one id across the main, pre and post
  threads, the `decode.step` spans equal the step counters' change, and
  the row counters match the decoded masks.
- `idle_by_span` splits the card's idle time by the main thread's
  innermost span, and its parts add up to the idle time.
- `device_clock` follows the profile's offset and drift from the kernels'
  launches: tight where a kernel was launched onto an idle card, within
  the drift bound between launches.
- On the card (marked `cuda`): a span around a sleep kernel holds the
  kernel's device interval once the clocks are joined, with the card idle
  and busy, through the profiler's events and through `trace()`'s Chrome
  trace.

No JAX here: the card's machine runs this file too.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from rgrg_tpu_torch.core import config as TC
from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.inference import ReportGenerator
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.serving import generate_reports_pipelined
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
from rgrg_tpu_torch.utils import logging as L
from rgrg_tpu_torch.utils.logging import span


@pytest.fixture(autouse=True)
def recorder_off():
    L.spans_off()
    yield
    L.spans_off()


def boom():
    raise AssertionError("a clock was read")


# ------------------------------------------------------------------ recorder

def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    monkeypatch.setattr(time, "time_ns", boom)
    assert span("a") is span("b", batch=3)       # one shared context
    with span("a"):
        with span("b", batch=1):
            pass
    monkeypatch.undo()
    assert L.drain_spans() == {"spans": [], "dropped": 0}
    L.spans_on()
    assert L.spans_off() == {"spans": [], "dropped": 0}


def test_on_records_names_parents_threads_and_batches():
    L.spans_on()
    with span("outer", batch=7):
        with span("inner"):
            pass
        seen = {}

        def worker():
            with span("side"):       # another thread: no parent across threads
                with span("side.child", batch=2):
                    pass
            seen["name"] = threading.current_thread().name
        t = threading.Thread(target=worker, name="side-thread")
        t.start()
        t.join()
    rec = L.spans_off()
    assert rec["dropped"] == 0
    by = {s["name"]: s for s in rec["spans"]}
    assert [s["name"] for s in rec["spans"]] == ["inner", "side.child", "side", "outer"]
    assert by["outer"]["parent"] == 0 and by["inner"]["parent"] == by["outer"]["id"]
    assert by["inner"]["batch"] == 7                 # a child takes its parent's batch
    assert by["side"]["parent"] == 0 and by["side"]["batch"] is None
    assert by["side.child"]["parent"] == by["side"]["id"] and by["side.child"]["batch"] == 2
    assert by["outer"]["thread"] == by["inner"]["thread"] == threading.current_thread().name
    assert by["side"]["thread"] == by["side.child"]["thread"] == seen["name"] == "side-thread"
    for s in rec["spans"]:
        assert s["start_ns"] <= s["end_ns"]
    assert by["outer"]["start_ns"] <= by["inner"]["start_ns"]
    assert by["inner"]["end_ns"] <= by["outer"]["end_ns"]


def test_the_bound_drops_spans_and_counts_them():
    L.spans_on(capacity=3)
    for k in range(5):
        with span(f"s{k}"):
            pass
    rec = L.drain_spans()
    assert [s["name"] for s in rec["spans"]] == ["s0", "s1", "s2"] and rec["dropped"] == 2
    with span("after"):            # a drain empties the buffer
        pass
    assert [s["name"] for s in L.spans_off()["spans"]] == ["after"]


def test_a_span_left_open_by_a_closed_generator_leaves_the_stack():
    L.spans_on()

    def gen():
        with span("gen"):
            yield 1
    g = gen()
    next(g)
    with span("caller"):
        g.close()                  # the generator's span closes under the caller's
    with span("next"):
        pass
    by = {s["name"]: s for s in L.spans_off()["spans"]}
    assert by["caller"]["parent"] == by["gen"]["id"]
    assert by["next"]["parent"] == 0


# ------------------------------------------------------------- attribution

def sp(name, start, end, thread="MainThread"):
    return {"name": name, "thread": thread, "start_ns": start, "end_ns": end}


def test_segments_follow_the_innermost_span():
    spans = [sp("b", 10, 20), sp("a", 0, 40), sp("c", 20, 30), sp("z", 0, 40, "other"),
             sp("d", 30, 40), sp("e", 30, 35)]
    assert L.span_segments(spans, "MainThread") == [
        (0, 10, "a"), (10, 20, "b"), (20, 30, "c"), (30, 35, "e"), (35, 40, "d")]


def test_idle_by_span_splits_gaps_and_adds_up():
    spans = [sp("serve.batch", 100, 900), sp("decode.step", 200, 400),
             sp("decode.read", 350, 400), sp("decode.step", 400, 600),
             sp("decode.read", 560, 600), sp("serve.yielded", 700, 800),
             sp("serve.preprocess", 0, 1000, "pre")]
    busy = [(150, 250), (300, 360), (240, 310), (590, 650), (980, 1200)]
    idle = L.idle_by_span(spans, busy, 0, 1000)
    # idle: [0, 150) [360, 590) [650, 980)
    want = {"(none)": 100 + 80, "serve.batch": 50 + 50 + 100, "decode.read": 40 + 30,
            "decode.step": 160, "serve.yielded": 100}
    assert idle.keys() == want.keys()
    for k, v in want.items():
        assert idle[k] == pytest.approx(v * 1e-9)
    assert sum(idle.values()) == pytest.approx((150 + 230 + 330) * 1e-9)
    # no device work: all of it idle, by span
    assert sum(L.idle_by_span(spans, [], 50, 950).values()) == pytest.approx(900e-9)


def test_device_clock_follows_the_launches():
    def offset(t):          # 0.3 ms at first, then drifting 0.3% from 1 s on
        return 300_000 - max(t - 1_000_000_000, 0) * 3 // 1000
    device, launches = [], {}
    for k in range(4000):   # a kernel launched every 0.5 ms on an idle card, 3 us after
        t = 100_000_000 + k * 500_000
        launches[k] = t
        device.append((t + 3_000 + offset(t), t + 13_000 + offset(t), k))
    # kernels that waited behind others (launched 2 ms before they ran) bound
    # it loosely; a copy has no launch
    for k in range(4000, 4400):
        t = 100_000_000 + (k - 4000) * 5_000_000 + 250_000
        launches[k] = t - 2_000_000
        device.append((t + offset(t), t + 10_000 + offset(t), k))
    device.append((5, 8, None))
    clock = L.device_clock(device, launches)
    for t in (200_000_000, 900_000_000, 1_500_000_000, 2_000_000_000):
        assert 0 <= clock(t) - (t + offset(t)) <= 3_000 + 5_000
    # sparse launches: the drift bound holds the map between them
    sparse = L.device_clock(device[:4000:200], launches)
    for t in (200_000_000, 1_500_000_000):
        assert 0 <= sparse(t) - (t + offset(t)) <= 3_000 + 0.01 * 50_000_000
    assert L.device_clock([(5, 8, None)], {})(123) == 123


# ----------------------------------------------------- the pipelined server

@pytest.fixture(scope="module")
def tiny_gen():
    dec = TC.DecoderConfig(vocab_size=300, hidden_dim=16, num_heads=2, num_layers=2,
                           max_positions=64, bos_token_id=0, eos_token_id=0,
                           pad_token_id=0, image_feature_dim=1024)
    cfg = TC.ModelConfig(detector=TC.DetectorConfig(
        backbone_stages=(1, 1, 1, 1), rpn=TC.RPNConfig(pre_nms_top_n_test=32)), decoder=dec)
    params = RGRG(cfg).init(0, "cpu")
    with torch.no_grad():   # select every detected region
        params["detector"].selection_classifier.fc2.bias += 50.0
    return ReportGenerator(params, GPT2Tokenizer.dummy(), cfg=cfg, similarity_fn=None)


@pytest.mark.parametrize("num_beams", [1, 2])
def test_pipelined_spans_and_counters(tiny_gen, num_beams):
    images = list(np.random.default_rng(0).integers(0, 256, (6, 300, 260), dtype=np.uint8))
    c0 = L.counters()
    L.spans_on()
    batches = list(generate_reports_pipelined(tiny_gen, images, batch_size=2,
                                              num_beams=num_beams, max_length=8,
                                              kv_cache_dtype=None))
    rec = L.spans_off()
    c1 = L.counters()
    delta = {k: c1[k] - c0[k] for k in c1}
    spans = rec["spans"]
    assert rec["dropped"] == 0

    # one id a batch across the three threads
    main = threading.current_thread().name
    for i in range(len(batches)):
        mine = [s for s in spans if s["batch"] == i]
        names = {s["name"] for s in mine}
        assert {"serve.batch", "serve.pre_wait", "serve.detect", "serve.select_read",
                "serve.post_wait", "serve.yielded", "serve.preprocess", "pre.upload",
                "serve.postprocess", "post.copy"} <= names
        threads = {s["name"]: s["thread"] for s in mine}
        assert threads["serve.batch"] == threads["serve.yielded"] == main
        assert threads["serve.preprocess"] == threads["pre.upload"] != main
        assert threads["serve.postprocess"] == threads["post.copy"] != main
        assert threads["serve.preprocess"] != threads["serve.postprocess"]
        assert sum(s["name"] == "serve.batch" for s in mine) == 1
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        parent = by_id.get(s["parent"])
        if s["name"] == "decode.step":
            assert parent["name"] in ("serve.detect", "serve.batch", "serve.select_read")
        if s["name"] in ("pre.upload", "post.copy"):
            assert parent["name"] in ("serve.preprocess", "serve.postprocess")

    # the spans count what the counters count
    steps = sum(s["name"] == "decode.step" for s in spans)
    counted = "beam_generate" if num_beams > 1 else "greedy_generate"
    assert steps == delta[f"{counted}.steps"] > 0
    reads = [s for s in spans if s["name"] == "decode.read"]
    assert sum(by_id[s["parent"]]["name"] == "decode.step" for s in reads) == steps

    # rows: the decoded masks, and the ladder's budget a batch
    reports = [r for b in batches for r in b]
    selected = [int(np.sum(r.selected_regions)) for r in reports]
    assert delta["generate_reports_pipelined.rows_selected"] == sum(selected)
    assert sum(len(r.region_sentences) for r in reports) == sum(selected)
    model = RGRG(tiny_gen.model.cfg)
    budgets = [model.budget_for(sum(selected[k:k + 2]), 2) for k in range(0, 6, 2)]
    rows = delta["greedy_generate.rows"] + delta["beam_generate.rows"]
    assert rows == sum(budgets) >= sum(selected) > 0
    assert delta[f"{counted}.rows"] == rows
    assert rows <= len(images) * C.NUM_REGIONS


# -------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def sleep_and_span(busy: bool):
    """A span around a ~1 ms sleep kernel's launch and the wait for it;
    busy: between a second of small kernels before it and half a second
    after (the profile's device times drift from the host's under load)."""
    x = torch.ones(64, 64, device="cuda")

    def load(seconds):
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            for _ in range(50):
                x.mul_(1.0)
        torch.cuda.synchronize()
    torch.cuda._sleep(1000)   # the profile's first launch pays its set-up
    torch.cuda.synchronize()
    if busy:
        load(1.0)
    with span("sleep"):
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
    if busy:
        load(0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("route,busy", [("profiler_events", False), ("chrome_trace", False),
                                        ("profiler_events", True), ("chrome_trace", True)])
def test_a_span_holds_its_kernel_on_the_device_clock(cuda, route, busy, tmp_path):
    """The profile's device times joined to the spans' clock through the
    kernels' launches (`device_clock`): the sleep kernel starts after its
    span opens and ends before it closes, each within 50 us."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    if route == "profiler_events":
        L.spans_on()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sleep_and_span(busy)
        s = L.spans_off()["spans"][0]
        cuda_type = torch.autograd.DeviceType.CUDA
        ev = prof.profiler.kineto_results.events()
        device = [(e.start_ns(), e.end_ns(), e.correlation_id()) for e in ev
                  if e.device_type() == cuda_type]
        launches = {e.correlation_id(): e.start_ns() for e in ev
                    if e.device_type() != cuda_type and "aunch" in e.name()}
        sleeps = [(e.start_ns(), e.end_ns()) for e in ev
                  if e.device_type() == cuda_type and "spin_kernel" in e.name()
                  and e.end_ns() - e.start_ns() > 500_000]
        to_device = L.device_clock(device, launches)
        start, end = to_device(s["start_ns"]), to_device(s["end_ns"])
        offsets = [(to_device(t) - t) / 1000 for t in (device[0][0], device[-1][1])]
    else:
        with L.trace(str(tmp_path)):
            sleep_and_span(busy)
        doc = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())
        base = doc.get("baseTimeNanoseconds", 0)
        ev = doc["traceEvents"]
        sleeps = [(base + e["ts"] * 1000, base + (e["ts"] + e["dur"]) * 1000) for e in ev
                  if e.get("cat") == "kernel" and "spin_kernel" in e["name"] and e["dur"] > 500]
        (s,) = [e for e in ev if e.get("cat") == "rgrg_span"]
        start, end = base + s["ts"] * 1000, base + (s["ts"] + s["dur"]) * 1000
        offsets = doc["rgrg"]["clock_offset_us"]
    (k0, k1), = sleeps
    lead, lag = k0 - start, end - k1
    print(f"{route}, busy {busy}: clock offsets {offsets[0]:.1f} / {offsets[-1]:.1f} us; "
          f"kernel {(k1 - k0) / 1e6:.3f} ms, starts {lead / 1e3:.1f} us after the span, "
          f"ends {lag / 1e3:.1f} us before it")
    assert 0 <= lead <= 50_000 and 0 <= lag <= 50_000

"""Closed-loop batch serving through `serving.generate_reports_pipelined`.

A seeded pool of uint8 X-rays is cycled through one call of the
pipelined server, as the serve CLI calls it: each batch is queued as soon
as the server takes the one before (a backlog), the traffic file fixes
the batch size, beams, max_length and KV cache. The first
`warmup_batches` batches are set-up; the window counts every report
yielded until the first yield at or after its end. A traced run then
profiles `trace_batches` more batches. Spans come from a proxy of the
generator's model around its detect and decode entries; the decode steps
are the program's own counters.
"""

from __future__ import annotations

import contextlib
import random
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.program import program_config, program_params
from port_bench.reference.vocab import text_ids
from port_bench.vocab import tokenizer
from port_bench.weights import calibrate_heads, make_weights, make_xrays

DECODE_ENTRIES = ("detect_and_decode", "decode_selected_cascade", "decode_selected")


class Spans:
    """Host time inside the model's detect and decode entries (a proxy of
    the generator's RGRG; calls the program makes inside those entries
    reach the real object and are not counted twice)."""

    def __init__(self, model):
        self._model = model
        self.seconds = {"decode": 0.0, "detect": 0.0}

    def __getattr__(self, name):
        attr = getattr(self._model, name)
        kind = "decode" if name in DECODE_ENTRIES else "detect" if name == "detect" else None
        if kind is None:
            return attr

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return attr(*args, **kwargs)
            finally:
                self.seconds[kind] += time.perf_counter() - t0
        return timed


def counters() -> Dict[str, int]:
    """The program's decode step counters."""
    from rgrg_tpu_torch.decode.beam import beam_generate
    from rgrg_tpu_torch.decode.greedy import greedy_generate
    return {"greedy_generate.steps": greedy_generate.steps,
            "beam_generate.steps": beam_generate.steps}


class AncestryTap:
    """While tracing: the ancestry table and slot of each beam-attention
    step (one copy a step on the device), which K3's byte count reads."""

    def __init__(self):
        from rgrg_tpu_torch.models import gpt2
        self._gpt2 = gpt2
        self._orig = gpt2.beam_attention
        self.steps: List[Dict] = []

    def __enter__(self):
        def tapped(q, k, v, anc, slot, **kw):
            last = self.steps[-1] if self.steps else None
            if last is None or last["slot"] != slot or last["ptr"] != anc.data_ptr():
                self.steps.append({"anc": anc.clone(), "slot": slot, "ptr": anc.data_ptr(),
                                   "t0": kw.get("t0", 0), "heads": q.shape[1],
                                   "head_dim": q.shape[2], "cache_dtype": str(k.dtype),
                                   "q_bytes": q.element_size(),
                                   "lanes": q.shape[0], "launches": 0})
            self.steps[-1]["launches"] += 1
            return self._orig(q, k, v, anc, slot, **kw)
        self._gpt2.beam_attention = tapped
        return self

    def __exit__(self, *exc):
        self._gpt2.beam_attention = self._orig
        return False


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.gen = self.stream = None
        # per pool image, one of its window's reports drawn uniformly from
        # the seed (reservoir sampling: nothing else of the reports is kept)
        self.kept: Dict[int, List] = {}
        self.draw = random.Random(seed)

    # ---------------------------------------------------------------- set-up

    def setup(self) -> None:
        from rgrg_tpu_torch.inference import ReportGenerator
        from rgrg_tpu_torch.serving import generate_reports_pipelined
        if self.device.type == "cuda":
            from rgrg_tpu_torch.ops import kernels
            kernels.build()
        cfg, tr = self.cfg, self.traffic
        mcfg = program_config(cfg)
        w = make_weights(cfg, self.seed, self.device)
        pool = make_xrays(tr["pool_images"], tuple(tr["image_shape"]), self.seed, self.device)
        t0 = time.perf_counter()
        self.biases = calibrate_heads(w, cfg, pool, tr["select_share"])
        # the reference's pass over the pool, not the program's set-up
        self.readout_s = time.perf_counter() - t0
        self.pool = list(pool.cpu().numpy())
        del pool
        params = program_params(w, mcfg, self.device)
        del w
        self.gen = ReportGenerator(params, tokenizer(cfg), cfg=mcfg, similarity_fn=None)
        self.spans = Spans(self.gen.model)
        self.gen.model = self.spans
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        n = tr["pool_images"] * tr["pool_cycles"]
        self.order = [i % tr["pool_images"] for i in range(n)]
        self.stream = generate_reports_pipelined(
            self.gen, [self.pool[i] for i in self.order], batch_size=tr["batch_size"],
            num_beams=tr["num_beams"], max_length=tr["max_length"],
            early_stopping=tr["early_stopping"], kv_cache_dtype=cfg["kv_cache_dtype"],
            device_resize=tr["device_resize"], weights_int8=cfg["weights_int8"])
        self.next_image = 0
        for _ in range(tr["warmup_batches"]):
            self._next()
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _next(self) -> Dict:
        reports = next(self.stream)
        first = self.next_image
        self.next_image += len(reports)
        return {"images": self.order[first:self.next_image], "reports": reports,
                "t": time.perf_counter()}

    # ---------------------------------------------------------------- window

    def window(self, seconds: float) -> Dict:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        c0, s0 = counters(), dict(self.spans.seconds)
        t0 = time.perf_counter()
        end = t0 + seconds
        work = []
        while True:
            b = self._next()
            work.append(self._keep(b))
            if b["t"] >= end:
                break
        t1 = b["t"]
        c1 = counters()
        reports = sum(w["images"] for w in work)
        return {"window_s": t1 - t0,
                "e2e": {"reports_per_s": reports / (t1 - t0)},
                "counters": {k: c1[k] - c0[k] for k in c1},
                "spans": {k: self.spans.seconds[k] - s0[k] for k in s0},
                "work": work,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(self.device) if cuda else 0,
                "attempted": reports, "failed": 0}

    def _keep(self, batch: Dict) -> Dict:
        """Samples the batch's reports for the check; returns the rows it
        decoded and their served lengths."""
        for img, rep in zip(batch["images"], batch["reports"]):
            seen = self.kept.setdefault(img, [0, None])
            seen[0] += 1
            if self.draw.randrange(seen[0]) == 0:
                seen[1] = rep
        lengths = [len(text_ids(s)) for rep in batch["reports"]
                   for s in rep.region_sentences.values()]
        return {"images": len(batch["reports"]), "row_tokens": lengths}

    # ----------------------------------------------------------------- trace

    def trace(self) -> Dict:
        from torch.profiler import ProfilerActivity, profile
        n = self.traffic["trace_batches"]
        self._sync()
        tap = AncestryTap() if self.traffic["num_beams"] > 1 else None
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with tap or contextlib.nullcontext():
                batches = [self._next() for _ in range(n)]
            self._sync()
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        return {"slice_s": t1 - t0, "postprocess_s": time.perf_counter() - t2,
                "events": events, "ancestry": [] if tap is None else tap.steps,
                "work": [self._keep(b) for b in batches]}

    # ------------------------------------------------------------ check

    def finish(self) -> None:
        """Stops the server's pipeline and frees the program's state."""
        if self.stream is not None:
            self.stream.close()
        self.stream = self.gen = self.spans = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self) -> Dict[int, Dict]:
        """Per pool image, its sampled report: detected, selected, boxes
        and served token ids."""
        from rgrg_tpu_torch.core.constants import ANATOMICAL_REGIONS
        cap = self.traffic["max_length"] - 1
        bos, eos = self.cfg["decoder"]["bos_token_id"], self.cfg["decoder"]["eos_token_id"]

        def served(text: str) -> List[int]:
            ids = text_ids(text)
            if bos != eos and ids[:1] == [bos]:
                ids = ids[1:]             # a row starts with BOS; decoding drops GPT-2's (= EOS)
            return ids + [eos] if len(ids) < cap else ids   # EOS ended a short row

        out = {}
        for img in sorted(self.kept):
            rep = self.kept[img][1]
            out[img] = {"detected": np.asarray(rep.class_detected, bool),
                        "selected": np.asarray(rep.selected_regions, bool),
                        "boxes": np.asarray(rep.top_region_boxes, np.float32),
                        "tokens": {ANATOMICAL_REGIONS[name]: served(s)
                                   for name, s in rep.region_sentences.items()}}
        return out

    def check(self, control: bool = False) -> Dict:
        """The reference's judgement of the window's outputs (after
        `finish`): {"program": numbers[, "control": numbers]}."""
        from port_bench.reference.judge_serve import judge
        from port_bench.reference.rgrg import Reference
        outs = self.outputs()
        imgs = sorted(outs)
        w = make_weights(self.cfg, self.seed, self.device)
        for name, b in self.biases.items():
            w[name].copy_(b)
        ref = Reference(self.cfg, w)
        ctrl = Reference(self.cfg, w, precision="fp8") if control else None
        pixels = torch.from_numpy(np.stack([self.pool[i] for i in imgs])).to(self.device)
        with torch.no_grad():
            return judge(ref, pixels, [outs[i] for i in imgs], self.traffic["num_beams"],
                         control=ctrl)

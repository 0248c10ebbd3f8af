"""Stage-3 training through the program's train step
(`train.trainer.make_train_step`), on batches that the program's loader
built in set-up.

Set-up makes the corpus from the seed: `corpus_images` uint8 X-rays of
`raw_shape` (drawn on the device, then held in host memory; the dataset
reads them through `data.transforms.load_image`, which the driver points
at them while it loads, as a split's files would be read) and their split
rows in the ETL's schema (`corpus_rows`). `data.dataset.RGRGDataset.batches`
with `workers` sample-building threads, behind `data.prefetch.prefetched`
as the train CLI wires them, builds `batch_pool` batches from them: the
train augmentations from a per-sample seed, the phrases' byte-pair
encode, the collate. The loader then stops; its batches stay host arrays,
which the step moves to the card as the CLI's step does.

Set-up then builds the weights, the program's TrainState and step, and
drives the step through the first `check_steps` mini-steps on the pool's
first batches (each step's draws and dropout seeded from the seed): these
warm up every shape and are what the reference follows. The window keeps
training the same state, cycling the pool, until `--seconds` have passed
and the device has finished. `finish` then runs the step on until the
accumulation's next update is due, records the state, and drives one more
mini-step, the update, through the same call: the reference follows that
one from the recorded state.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench.program import program_config, program_params, train_config
from port_bench.reference.train import seeded
from port_bench.reference.vocab import word
from port_bench.vocab import tokenizer
from port_bench.weights import make_weights, make_xrays

STEADY_STEP = 10**6   # the draws' index of the step judged after the window


def corpus_rows(cfg: Dict, traffic: Dict, seed: int) -> Tuple[List[Dict], List[int]]:
    """`corpus_images` split rows: ground-truth boxes of the 29 regions in
    the raw image's pixels (a `gt_missing_share` of them absent),
    `sentences_per_image` present regions with a phrase of
    `sentence_words` words drawn from `phrase_words` words of the
    vocabulary, `abnormal_per_image` of those abnormal. Every seed gets
    the same counts and ranges; only which and where differ. Returns the
    rows and the phrase words' ids."""
    d, r = cfg["decoder"], cfg["num_regions"]
    rng = np.random.default_rng([seed, 0x7EA1])
    h, w = traffic["raw_shape"]
    ids = [i for i in rng.choice(d["vocab_size"], traffic["phrase_words"] + 1, replace=False)
           if i != d["eos_token_id"]][:traffic["phrase_words"]]
    lo, hi = traffic["sentence_words"]
    rows = []
    for n in range(traffic["corpus_images"]):
        u = rng.uniform(size=(r, 4))
        cx, cy = (0.15 + 0.7 * u[:, 0]) * w, (0.15 + 0.7 * u[:, 1]) * h
        bw, bh = (0.08 + 0.42 * u[:, 2]) * w, (0.08 + 0.42 * u[:, 3]) * h
        boxes = np.stack([np.maximum(cx - bw / 2, 0), np.maximum(cy - bh / 2, 0),
                          np.minimum(cx + bw / 2, w), np.minimum(cy + bh / 2, h)], -1).round(1)
        present = np.flatnonzero(rng.uniform(size=r) >= traffic["gt_missing_share"])
        order = rng.permutation(present)
        has = np.zeros(r, bool)
        has[order[:traffic["sentences_per_image"]]] = True
        abnormal = np.zeros(r, bool)
        abnormal[order[:traffic["abnormal_per_image"]]] = True
        lengths = rng.integers(lo, hi + 1, r)
        phrases = [" " + " ".join(word(int(i)) for i in rng.choice(ids, lengths[k]))
                   if has[k] else "" for k in range(r)]
        rows.append({"mimic_image_file_path": f"mem://{n}",
                     "bbox_coordinates": boxes[present].tolist(),
                     "bbox_labels": (present + 1).tolist(),
                     "bbox_phrases": phrases, "bbox_phrase_exists": has.tolist(),
                     "bbox_is_abnormal": abnormal.tolist()})
    return rows, ids


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.state = self.step_fn = None
        self.record: Dict = {}
        self.readout_s = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------------- set-up

    def _load_pool(self) -> None:
        """`batch_pool` batches from the program's loader, then stops it:
        its producer ends after the batch in hand, the batches it queued
        are drained, and its threads have ended."""
        from rgrg_tpu_torch.data import transforms
        from rgrg_tpu_torch.data.dataset import RGRGDataset
        from rgrg_tpu_torch.data.prefetch import prefetched
        tr, t = self.traffic, self.cfg["train"]
        self.rows, phrase_ids = corpus_rows(self.cfg, tr, self.seed)
        pixels = make_xrays(tr["corpus_images"], tuple(tr["raw_shape"]), self.seed, self.device)
        arrays = {row["mimic_image_file_path"]: a for row, a in zip(self.rows, pixels.cpu().numpy())}
        del pixels
        ds = RGRGDataset(self.rows, tokenizer(self.cfg, phrase_ids), train=True,
                         seq_len=t["seq_len"], seed=self.seed)
        stop = threading.Event()

        def epochs():
            while not stop.is_set():
                with contextlib.closing(ds.batches(t["batch_size"], shuffle=True,
                                                   workers=tr["workers"])) as epoch:
                    for batch in epoch:
                        yield batch
                        if stop.is_set():
                            return
        load_image, transforms.load_image = transforms.load_image, arrays.__getitem__
        try:
            loader = prefetched(epochs(), depth=tr["prefetch"])
            self.pool = [next(loader) for _ in range(tr["batch_pool"])]
            stop.set()
            for _ in loader:
                pass
        finally:
            transforms.load_image = load_image

    def setup(self) -> None:
        from rgrg_tpu_torch.models.full_model import RGRG
        from rgrg_tpu_torch.train import trainer
        if self.device.type == "cuda":
            from rgrg_tpu_torch.ops import kernels
            kernels.build()
        cfg, t = self.cfg, self.cfg["train"]
        mcfg, tcfg = program_config(cfg), train_config(cfg)
        self._load_pool()
        self.next_batch = 0
        params = program_params(make_weights(cfg, self.seed, self.device), mcfg, self.device)
        self.state = trainer.TrainState(params, trainer.make_optimizer(params, tcfg, t["stage"]), 0)
        self.step_fn = trainer.make_train_step(RGRG(mcfg), tcfg, stage=t["stage"],
                                               lm_budget=t["lm_budget"])
        ids = {id(p): n for n, p in params["detector"].named_parameters()}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + k + ".")
                else:
                    ids[id(v)] = prefix + k
        walk(params["decoder"], "decoder.")
        opt = self.state.opt_state
        self.names = [ids[id(p)] for p in opt.tensors]
        self.check_batches, losses = [], []
        for k in range(self.traffic["check_steps"]):
            batch = self._batch()
            self.check_batches.append(batch)
            self.state, out = self.step_fn(self.state, batch, seeded(self.device, self.seed, k))
            losses.append({name: float(v) for name, v in out.items()})
            if k == 0:
                grads = {n: float(a.norm()) for n, a in zip(self.names, opt.acc)}
        # the check's readout of each tensor's change, not set-up
        t0 = time.perf_counter()
        init = make_weights(cfg, self.seed, self.device)
        change = {n: float((p.detach() - init[n]).norm()) for n, p in zip(self.names, opt.tensors)}
        del init
        self.record = {"losses": losses, "grads": grads, "change": change}
        self.readout_s = time.perf_counter() - t0
        self.rng = torch.Generator(device=self.device).manual_seed(self.seed * 13)
        self._sync()

    # ---------------------------------------------------------------- window

    def _batch(self) -> Dict:
        batch = self.pool[self.next_batch % len(self.pool)]
        self.next_batch += 1
        return batch

    def _step(self) -> float:
        """One mini-step on the pool's next batch; returns its mean tokens
        a row with a sentence."""
        batch = self._batch()
        self.state, _ = self.step_fn(self.state, batch, self.rng)
        mask, has = batch["attention_mask"], batch["region_has_sentence"]
        return float(mask.sum()) / max(int(has.sum()), 1)

    def window(self, seconds: float) -> Dict:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        end, tokens, steps = t0 + seconds, 0.0, 0
        while time.perf_counter() < end:
            tokens, steps = tokens + self._step(), steps + 1
        self._sync()
        t1 = time.perf_counter()
        images = steps * self.cfg["train"]["batch_size"]
        return {"window_s": t1 - t0, "e2e": {"train_images_per_s": images / (t1 - t0)},
                "steps": steps, "mean_tokens": tokens / max(steps, 1),
                "attempted": images, "failed": 0,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(self.device) if cuda else 0}

    def trace(self) -> Dict:
        from torch.profiler import ProfilerActivity, profile
        n = self.traffic["trace_steps"]
        self._sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                self._step()
            self._sync()
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        return {"slice_s": t1 - t0, "steps": n, "postprocess_s": time.perf_counter() - t2,
                "events": events}

    # ----------------------------------------------------------------- check

    def _steady(self) -> None:
        """The state the window left, at the accumulation's last mini-step,
        and that mini-step (the update) through the window's own call."""
        opt = self.state.opt_state
        for _ in range(opt.k):        # a step that never counts gets no more
            if opt.mini_step == opt.k - 1:
                break
            self._step()
        batch = self._batch()
        with torch.no_grad():
            adam = [opt.adamw.state.get(p, {}) for p in opt.tensors]
            snap = {n: {"param": p.detach().clone(), "acc": a.clone(),
                        "m": s["exp_avg"].clone() if s else torch.zeros_like(p),
                        "v": s["exp_avg_sq"].clone() if s else torch.zeros_like(p)}
                    for n, p, a, s in zip(self.names, opt.tensors, opt.acc, adam)}
            updates = int(adam[0]["step"]) if adam[0] else 0
        self.state, out = self.step_fn(self.state, batch,
                                       seeded(self.device, self.seed, STEADY_STEP))
        with torch.no_grad():
            change = {n: float((p.detach() - snap[n]["param"]).norm())
                      for n, p in zip(self.names, opt.tensors)}
        self.steady = {"batch": batch, "state": snap, "updates": updates,
                       "mini_step": opt.k - 1, "step": STEADY_STEP,
                       "losses": [{k: float(v) for k, v in out.items()}], "change": change}

    def finish(self) -> None:
        """Runs the judged step after the window and frees the program's
        state."""
        if self.state is not None:
            self._steady()
        self.state = self.step_fn = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> Dict:
        """The reference follows the check steps from the same weights,
        batches and draws, and the judged step from the recorded state;
        the loader's batches are checked against the corpus by
        themselves: {"program": numbers[, "control": numbers]}, the
        control being the reference with TF32 products."""
        from port_bench.reference.judge_train import judge
        init = make_weights(self.cfg, self.seed, self.device)
        return judge(self.cfg, init, self.check_batches, self.record, self.seed, control,
                     steady=self.steady, rows=self.rows, loaded=self.pool)

"""Certify `inference_proposal_budget` on trained weights.

The serving knob RoIConfig.inference_proposal_budget compacts the NMS
survivors to the front and runs the RoI head on the first `budget` slots
only. It is exact whenever every image's survivors fit the budget. On
random weights objectness is noise and the survivors fill the whole
post-NMS capacity (1000), so a budget drops real regions; on trained
weights RPN objectness concentrates on a few hundred boxes. This tool
measures that on a trained detector:

  1. the post-NMS survivor count (`keep.sum(1)`) of each held-out image;
  2. the agreement of the detections with and without each budget: the
     largest change of a top region box (px) and whether `class_detected`
     is identical;
  3. the smallest tested budget with identical classes and boxes within
     1e-3 px (`smallest_safe_budget_tested`);
  4. with --ladder, also the ladder value above the survivors' maximum
     (full_model.ladder_budget), the budget a serving deployment would
     pick for this checkpoint;
  5. with --time-detect B, detect's time at batch B without a budget and at
     the smallest safe one (synchronized, a fresh batch of images each
     repetition, one warm-up per budget).

The trained weights come from --ckpt, a checkpoint directory the port
wrote (train.loop.train's `<run_dir>/last`, e.g. the three-stage
rehearsal's stage-3 checkpoint), or else from stage 1 trained here on the
synthetic 29-region corpus of `synth_batch`. Runs on the card unless
`--device cpu` is given:

    python -m rgrg_tpu_torch.tools.validate_proposal_budget --ckpt DIR \\
        --ladder --time-detect 32
    python -m rgrg_tpu_torch.tools.validate_proposal_budget --shallow \\
        --steps 8 --device cpu

Prints the summary as JSON and writes it to --out when given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rgrg_tpu_torch.core.config import (DecoderConfig, DetectorConfig, ModelConfig,
                                        TrainConfig)
from rgrg_tpu_torch.core.device import resolve_device
from rgrg_tpu_torch.models.detector import RegionDetector
from rgrg_tpu_torch.models.full_model import RGRG, ladder_budget

Params = Dict[str, Any]


def synth_batch(rng: np.random.Generator, batch: int, size: int = 512) -> Dict[str, np.ndarray]:
    """29 bright rectangles on a 6x5 grid, geometry jittered per sample:
    every region present once, boxes ~40-90 px, mild overlap, a noisy
    background, and a region-dependent intensity so the RoI classifier can
    tell the regions apart. Numpy arrays; the caller moves them."""
    images = rng.normal(0.0, 0.15, (batch, size, size, 1)).astype(np.float32)
    boxes = np.zeros((batch, 29, 4), np.float32)
    for b in range(batch):
        for r in range(29):
            gy, gx = divmod(r, 6)
            cx = 45 + gx * 80 + rng.uniform(-12, 12)
            cy = 55 + gy * 95 + rng.uniform(-12, 12)
            w = rng.uniform(40, 90)
            h = rng.uniform(40, 90)
            x0 = float(np.clip(cx - w / 2, 0, size - 2))
            y0 = float(np.clip(cy - h / 2, 0, size - 2))
            x1 = float(np.clip(cx + w / 2, x0 + 4, size - 1))
            y1 = float(np.clip(cy + h / 2, y0 + 4, size - 1))
            boxes[b, r] = (x0, y0, x1, y1)
            level = 0.6 + 0.4 * (r / 28.0)
            images[b, int(y0):int(y1), int(x0):int(x1), 0] += level
    return {"images": images,
            "gt_boxes": boxes,
            "gt_labels": np.tile(np.arange(1, 30, dtype=np.int32), (batch, 1)),
            "gt_valid": np.ones((batch, 29), bool)}


@torch.inference_mode()
def survivors(det: RegionDetector, images: torch.Tensor) -> torch.Tensor:
    """Post-NMS survivors per image [B] at the test top-n."""
    _, keep = det.rpn_proposals(det.backbone(images))
    return keep.sum(dim=1)


def model_with(model: RGRG, params: Params, budget: Optional[int]) -> Tuple[RGRG, Params]:
    """`model` with inference_proposal_budget=budget, and params whose
    detector is built for that config and holds the trained detector's
    state (RGRG.detect refuses a detector of another config). Nothing is
    copied: the detector is built without storage and takes the trained
    detector's tensors, and the decoder tensors are params' own."""
    roi = dataclasses.replace(model.cfg.detector.roi, inference_proposal_budget=budget)
    dcfg = dataclasses.replace(model.cfg.detector, roi=roi)
    trained = params["detector"]
    det = RegionDetector(dcfg, device=torch.device("meta"))
    det.load_state_dict(trained.state_dict(), assign=True)
    det.anchors = trained.anchors   # not in the state dict
    det.eval()
    return (RGRG(cfg=dataclasses.replace(model.cfg, detector=dcfg)),
            {"detector": det, "decoder": params["decoder"]})


def detect_with(model: RGRG, params: Params, budget: Optional[int],
                images: torch.Tensor) -> Dict[str, torch.Tensor]:
    m, p = model_with(model, params, budget)
    return m.detect(p, images)


def agreement(out: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Tuple[float, bool]:
    """(largest |box change| in px, class_detected identical) of a budgeted
    detection against the unbudgeted one."""
    delta = (out["top_region_boxes"] - ref["top_region_boxes"]).abs().max().item()
    return float(delta), bool(torch.equal(out["class_detected"], ref["class_detected"]))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_detect(models: Dict[Optional[int], Tuple[RGRG, Params]], budget: int,
                rng: np.random.Generator, batch: int, iters: int = 10) -> Dict[str, Any]:
    """ms per detect at `batch` images without a budget and at `budget`:
    one warm-up per budget, then `iters` calls, each on its own batch of
    images, timed between device synchronizations; with the device's name."""
    m, p = models[None]
    dev = next(p["detector"].parameters()).device
    size = m.cfg.detector.image_size
    reps = [torch.from_numpy(synth_batch(rng, batch, size)["images"]).to(dev)
            for _ in range(iters)]
    timing = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for b in (None, budget):
        m, p = models[b]
        m.detect(p, reps[0])
        _sync(dev)
        t0 = time.perf_counter()
        for images in reps:
            m.detect(p, images)
        _sync(dev)
        timing["unbudgeted" if b is None else f"budget_{b}"] = round(
            (time.perf_counter() - t0) / iters * 1e3, 3)
    return timing


def certify(model: RGRG, params: Params, budgets: Sequence[int] = (600, 300, 150),
            batch: int = 4, eval_batches: int = 4, ladder: bool = False,
            time_detect_batch: int = 0, rng: Optional[np.random.Generator] = None,
            ladder_rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
    """Survivors, per-budget agreement and the smallest safe budget of the
    trained `params` over `eval_batches` batches of `synth_batch(rng,
    batch)` at the detector's input size (rng: default_rng(0)). ladder: first measure the survivors'
    maximum on an independent draw (ladder_rng: default_rng(12345)) and add
    its ladder budget when it is below the capacity. time_detect_batch > 0:
    also detect's ms at that batch, unbudgeted vs the smallest safe budget."""
    rng = np.random.default_rng(0) if rng is None else rng
    budgets = list(budgets)
    det = params["detector"]
    dev = next(det.parameters()).device
    capacity = int(model.cfg.detector.rpn.pre_nms_top_n_test)

    def images_of(r, b):
        return torch.from_numpy(synth_batch(r, b, model.cfg.detector.image_size)["images"]
                                ).to(dev)

    if ladder:
        rng_l = np.random.default_rng(12345) if ladder_rng is None else ladder_rng
        smax = max(int(survivors(det, images_of(rng_l, batch)).max())
                   for _ in range(eval_batches))
        lb = ladder_budget(smax)
        if lb < capacity and lb not in budgets:
            print(f"ladder: survivors_max {smax} -> certifying budget {lb}", file=sys.stderr)
            budgets.append(lb)

    models = {b: model_with(model, params, b) for b in [None] + budgets}
    counts: List[int] = []
    agreements = {b: {"boxes": [], "cls": []} for b in budgets}
    for _ in range(eval_batches):
        images = images_of(rng, batch)
        counts.extend(survivors(det, images).tolist())
        ref = models[None][0].detect(models[None][1], images)
        for b in budgets:
            delta, same = agreement(models[b][0].detect(models[b][1], images), ref)
            agreements[b]["boxes"].append(delta)
            agreements[b]["cls"].append(same)

    summary: Dict[str, Any] = {
        "post_nms_capacity": capacity,
        "survivors_max": int(max(counts)),
        "survivors_mean": round(float(np.mean(counts)), 1),
        "budget_agreement": {
            str(b): {"max_box_delta_px": round(max(v["boxes"]), 4),
                     "class_detected_identical": all(v["cls"])}
            for b, v in agreements.items()},
    }
    safe = [b for b in sorted(budgets)
            if summary["budget_agreement"][str(b)]["class_detected_identical"]
            and summary["budget_agreement"][str(b)]["max_box_delta_px"] < 1e-3]
    summary["smallest_safe_budget_tested"] = safe[0] if safe else None
    if time_detect_batch and safe:
        summary[f"detect_ms_at_B{time_detect_batch}"] = time_detect(
            models, safe[0], rng, time_detect_batch)
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150,
                    help="stage-1 mini-steps trained here when --ckpt is not given")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--budgets", type=int, nargs="*", default=[600, 300, 150])
    ap.add_argument("--out", default=None)
    ap.add_argument("--lr", type=float, default=1e-4,
                    help="stage-1 LR (below the reference's 1e-3: small synthetic "
                         "batches diverge at 1e-3)")
    ap.add_argument("--shallow", action="store_true",
                    help="shallow backbone (1, 1, 1, 1)")
    ap.add_argument("--ckpt", default=None,
                    help="a checkpoint directory the port wrote (e.g. the three-stage "
                         "rehearsal's stage3/last): certify its trained detector "
                         "instead of training one here")
    ap.add_argument("--time-detect", type=int, default=0, metavar="B",
                    help="also time detect at batch B: no budget vs the smallest "
                         "safe budget")
    ap.add_argument("--ladder", action="store_true",
                    help="also certify ladder_budget(survivors_max), the budget a "
                         "deployment would serve for this checkpoint")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def default_config(shallow: bool) -> ModelConfig:
    """The full detector (or the shallow one) and a tiny decoder that
    detect never runs."""
    return ModelConfig(
        detector=DetectorConfig(backbone_stages=(1, 1, 1, 1) if shallow else (3, 4, 6, 3)),
        decoder=DecoderConfig(vocab_size=64, hidden_dim=64, num_heads=2, num_layers=2,
                              max_positions=64))


def train_stage1(model: RGRG, steps: int, batch: int, lr: float, rng: np.random.Generator,
                 device: torch.device) -> Params:
    """Stage 1 on `synth_batch`, one mini-step an update, from seed 0."""
    from rgrg_tpu_torch.train import trainer
    tcfg = TrainConfig(batch_size=batch, grad_accumulation_steps=1)
    state = trainer.init_train_state(model, 0, tcfg, stage=1, learning_rate=lr,
                                     device=device)
    step_fn = trainer.make_train_step(model, tcfg, stage=1)
    draws = torch.Generator(device=device).manual_seed(1)
    print(f"training stage-1 on synthetic 29-region corpus, {steps} steps @ batch {batch}",
          file=sys.stderr)
    t0 = time.time()
    for i in range(steps):
        state, losses = step_fn(state, synth_batch(rng, batch), draws)
        if i % 25 == 0 or i == steps - 1:
            ls = {k: round(float(v), 4) for k, v in losses.items()}
            print(f"  step {i}: {ls} ({time.time() - t0:.0f}s)", file=sys.stderr)
    state.params["detector"].eval()
    return state.params


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = default_config(args.shallow)
    model = RGRG(cfg=cfg)
    rng = np.random.default_rng(0)
    if args.ckpt:
        from rgrg_tpu_torch.core.checkpoint import load_params
        params = load_params(args.ckpt, cfg, device)
        print(f"certifying trained detector from {args.ckpt}", file=sys.stderr)
    else:
        params = train_stage1(model, args.steps, args.batch, args.lr, rng, device)
    summary = {("ckpt" if args.ckpt else "steps"): args.ckpt or args.steps}
    summary.update(certify(model, params, args.budgets, args.batch, args.eval_batches,
                           args.ladder, args.time_detect, rng))
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()

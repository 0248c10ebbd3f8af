"""Rehearse the reference's three-stage training protocol end to end.

  stage 1: the object detector alone                      -> checkpoint
  stage 2: detector + the two binary classifiers, warm-started from
           stage 1's detector                              -> checkpoint
  stage 3: the full model with the language model, warm-started from
           stage 2's params                                -> checkpoint
  then:    evaluate the stage-3 params (beam 4 with early stopping, NLG
           metrics, txt artifacts, bbox figures) and certify the serving
           proposal budget on the stage-3 checkpoint
           (tools/validate_proposal_budget.py, with --ladder).

Real data and weights are not in the repository, so the rehearsal trains
on a synthetic corpus of the task's shape (`build_corpus_batch`): 29
bright rectangles in the anatomical-grid layout, each with a
region-dependent intensity, ~50% of the regions carrying a short
byte-tokenized phrase ("The r<i> is normal." / "... abnormal."), abnormal
regions drawn brighter. Every stage runs the port's own path:
`train.loop.train` (checkpoints, plateau scheduler, eval-mode validation
losses every half stage) with `warm_start_params` handoffs, then
`eval.evaluator.evaluate_model`.

The model is the full detector (ResNet-50, `DetectorConfig()`) and a
reduced GPT-2 decoder (4 layers x 256 wide, 4 heads, the dummy tokenizer's
257-token byte vocabulary, 64 positions); --shallow takes a shallow
backbone and a 2 x 32 decoder. Runs on the card unless `--device cpu`:

    python -m rgrg_tpu_torch.tools.three_stage_rehearsal
    python -m rgrg_tpu_torch.tools.three_stage_rehearsal --shallow \\
        --stage1-steps 8 --stage2-steps 4 --stage3-steps 8 --batch 2 --device cpu

Checkpoints go under --run-dir and are deleted as the run goes (a stage's
training state is 2-3 GB): each stage's `last` is reloaded through
core/checkpoint.load_params and compared with the params in memory, then
removed once the next step no longer needs it. The summary (per-stage
validation losses and wall times, the final evaluation's scores, the share
of decoded rows that closed before max_length, each batch's decode row
budget, the cascade snapshot and the budget check) is printed and written to --out; figures need
matplotlib (`--num-figure-images 0` without it).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from rgrg_tpu_torch.core.checkpoint import load_params
from rgrg_tpu_torch.core.config import (DecoderConfig, DetectorConfig, GenerationConfig,
                                        MeshConfig, ModelConfig, RGRGConfig, TrainConfig)
from rgrg_tpu_torch.core.device import resolve_device
from rgrg_tpu_torch.eval import evaluator as EV
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
from rgrg_tpu_torch.tools import validate_proposal_budget as budget_check
from rgrg_tpu_torch.train import loop as train_loop
from rgrg_tpu_torch.train import trainer

REGION_TAGS = [f"r{i}" for i in range(29)]
# summary entries the port adds to the reference rehearsal's layout
PORT_ONLY_KEYS = ("final_eval.language_generation", "proposal_budget")
# entries whose own keys depend on what was decoded (which regions got a
# sentence, whether any report was assembled)
DATA_DEPENDENT_KEYS = ("final_eval.sentence", "final_eval.report")


def build_corpus_batch(rng: np.random.Generator, batch: int, tokenizer: GPT2Tokenizer,
                       seq_len: int = 40, size: int = 512,
                       with_text: bool = True) -> Dict[str, Any]:
    """One synthetic batch with the full stage-3 schema, as numpy arrays
    (and the reference phrases and reports when with_text). The geometry
    is validate_proposal_budget.synth_batch's; each region also gets
      - region_has_sentence ~ Bernoulli(0.5),
      - region_is_abnormal ~ Bernoulli(0.2), abnormal regions drawn
        brighter (+0.35) so the feature carries the signal,
      - the phrase "The <tag> is normal." / "... is abnormal.",
        byte-tokenized and wrapped in BOS / EOS."""
    images = rng.normal(0.0, 0.15, (batch, size, size, 1)).astype(np.float32)
    boxes = np.zeros((batch, 29, 4), np.float32)
    has_sentence = rng.uniform(size=(batch, 29)) < 0.5
    is_abnormal = rng.uniform(size=(batch, 29)) < 0.2
    input_ids = np.full((batch, 29, seq_len), tokenizer.pad_token_id, np.int32)
    attention_mask = np.zeros((batch, 29, seq_len), np.float32)
    phrases = []
    reports = []
    for b in range(batch):
        row_phrases = []
        report_sents = []
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
            level = 0.6 + 0.4 * (r / 28.0) + (0.35 if is_abnormal[b, r] else 0.0)
            images[b, int(y0):int(y1), int(x0):int(x1), 0] += level
            state = "abnormal" if is_abnormal[b, r] else "normal"
            phrase = f"The {REGION_TAGS[r]} is {state}." if has_sentence[b, r] else ""
            row_phrases.append(phrase)
            if phrase:
                report_sents.append(phrase)
                toks = tokenizer.encode(phrase, add_special=True)[:seq_len]
                input_ids[b, r, :len(toks)] = toks
                attention_mask[b, r, :len(toks)] = 1.0
        phrases.append(row_phrases)
        reports.append(" ".join(report_sents))
    batch_dict = {
        "images": images,
        "gt_boxes": boxes,
        "gt_labels": np.tile(np.arange(1, 30, dtype=np.int32), (batch, 1)),
        "gt_valid": np.ones((batch, 29), bool),
        "region_has_sentence": has_sentence,
        "region_is_abnormal": is_abnormal,
        "input_ids": input_ids,
        "attention_mask": attention_mask,
    }
    if with_text:
        batch_dict["reference_phrases"] = phrases
        batch_dict["reference_reports"] = reports
    return batch_dict


def model_config(tokenizer: GPT2Tokenizer, shallow: bool = False,
                 seq_len: int = 40) -> ModelConfig:
    """The full detector and a 4 x 256 GPT-2 over the tokenizer's vocabulary
    (shallow: a (1, 1, 1, 1) backbone and a 2 x 32 decoder); generation
    max_length = seq_len."""
    special = dict(bos_token_id=tokenizer.bos_token_id, eos_token_id=tokenizer.eos_token_id,
                   pad_token_id=tokenizer.pad_token_id)
    if shallow:
        det = DetectorConfig(backbone_stages=(1, 1, 1, 1))
        dec = DecoderConfig(vocab_size=tokenizer.vocab_size, hidden_dim=32, num_heads=2,
                            num_layers=2, max_positions=64, **special)
    else:
        det = DetectorConfig()
        dec = DecoderConfig(vocab_size=tokenizer.vocab_size, hidden_dim=256, num_heads=4,
                            num_layers=4, max_positions=64, **special)
    return ModelConfig(detector=det, decoder=dec,
                       generation=GenerationConfig(max_length=seq_len))


def key_paths(tree: Dict[str, Any], prefix: str = "") -> set:
    """Dotted paths of every key of a summary, not descending into
    DATA_DEPENDENT_KEYS."""
    paths = set()
    for k, v in tree.items():
        path = f"{prefix}{k}"
        paths.add(path)
        if isinstance(v, dict) and path not in DATA_DEPENDENT_KEYS:
            paths |= key_paths(v, path + ".")
    return paths


def reference_key_paths(summary: Dict[str, Any]) -> set:
    """key_paths without the port's additions (PORT_ONLY_KEYS): the layout
    of the JAX package's docs/artifacts/three_stage_rehearsal.json."""
    return {p for p in key_paths(summary)
            if not any(p == q or p.startswith(q + ".") for q in PORT_ONLY_KEYS)}


class ClosureCount:
    """`model` for evaluate_model, counting the decoded rows and those that
    closed before max_length (the last slot holds pad: the row emitted EOS
    earlier), and keeping each batch's decode row budget (the items of
    its beam-attention launches)."""

    def __init__(self, model: RGRG):
        self.model = model
        self.rows = 0
        self.closed = 0
        self.row_budgets: List[int] = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_selected_cascade(self, *args, **kw):
        ids, decoded = self.model.decode_selected_cascade(*args, **kw)
        closed = decoded & (ids[..., -1] == self.model.cfg.decoder.pad_token_id)
        rows = int(decoded.sum())
        self.rows += rows
        self.closed += int(closed.sum())
        self.row_budgets.append(self.model.budget_for(rows, ids.shape[0]))
        return ids, decoded


def _same(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _detector_tensors(params: Dict[str, Any]) -> List[torch.Tensor]:
    return list(params["detector"].state_dict().values())


@contextlib.contextmanager
def watch_handoffs(run_dir: str, wrap_step: Optional[Callable] = None
                   ) -> Iterator[Dict[str, Any]]:
    """Watch a rehearsal writing to `run_dir`: the params that enter each
    stage's first mini-step against the checkpoint the stage before left,
    and every checkpoint the rehearsal loads. Yields a dict that fills as
    the run goes:
      entering: the stages, in the order their first mini-step ran;
      loaded: each checkpoint loaded, relative to run_dir;
      "stage 2 begins with stage 1's final detector",
      "stage 3 begins with stage 2's params" (bit for bit),
      "stage 3 moved the decoder" (stage3/last against what entered it).
    wrap_step(stage, step) -> step optionally wraps each stage's train step
    (e.g. to time it)."""
    module = sys.modules[__name__]
    make_step, load = trainer.make_train_step, module.load_params
    seen: Dict[str, Any] = {"entering": [], "loaded": []}
    kept: Dict[int, Any] = {}

    def watching_step(model, tcfg, stage=3, **kw):
        step = make_step(model, tcfg, stage=stage, **kw)
        if wrap_step is not None:
            step = wrap_step(stage, step)

        def run(state, batch, rng):
            if stage not in seen["entering"]:
                seen["entering"].append(stage)
                det = _detector_tensors(state.params)
                dec = trainer.leaves(state.params["decoder"])
                if stage == 2:
                    seen["stage 2 begins with stage 1's final detector"] = _same(
                        det, kept.pop(1))
                elif stage == 3:
                    want_det, want_dec = kept.pop(2)
                    seen["stage 3 begins with stage 2's params"] = (
                        _same(det, want_det) and _same(dec, want_dec))
                    kept[3] = [t.clone() for t in dec]
            return step(state, batch, rng)
        return run

    def watching_load(path, *a, **kw):
        params = load(path, *a, **kw)
        name = os.path.relpath(path, run_dir)
        seen["loaded"].append(name)
        if name == os.path.join("stage1", "last"):
            kept[1] = [t.clone() for t in _detector_tensors(params)]
        elif name == os.path.join("stage2", "last"):
            kept[2] = ([t.clone() for t in _detector_tensors(params)],
                       [t.clone() for t in trainer.leaves(params["decoder"])])
        elif name == os.path.join("stage3", "last") and 3 in kept:
            seen["stage 3 moved the decoder"] = not _same(
                trainer.leaves(params["decoder"]), kept.pop(3))
        return params

    trainer.make_train_step, module.load_params = watching_step, watching_load
    try:
        yield seen
    finally:
        trainer.make_train_step, module.load_params = make_step, load


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage1-steps", type=int, default=400)
    ap.add_argument("--stage2-steps", type=int, default=150)
    ap.add_argument("--stage3-steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=40)
    ap.add_argument("--lm-budget", type=int, default=128)
    ap.add_argument("--eval-batches", type=int, default=3)
    ap.add_argument("--run-dir", default=os.path.join("build", "three_stage_rehearsal"))
    ap.add_argument("--out", default=os.path.join("chiprun_out", "three_stage_rehearsal.json"))
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--shallow", action="store_true",
                    help="shallow backbone + a 2 x 32 decoder")
    ap.add_argument("--num-figure-images", type=int, default=2,
                    help="bbox figures of the first evaluation images (needs "
                         "matplotlib; 0 disables)")
    ap.add_argument("--budgets", type=int, nargs="*", default=[600, 300, 150],
                    help="proposal budgets certified on the stage-3 checkpoint "
                         "(the ladder value is added)")
    ap.add_argument("--budget-batch", type=int, default=4)
    ap.add_argument("--budget-eval-batches", type=int, default=4)
    ap.add_argument("--time-detect", type=int, default=0, metavar="B",
                    help="also time detect at batch B: no budget vs the smallest "
                         "safe budget")
    ap.add_argument("--budget-out", default=None,
                    help="also write the budget check's summary here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _same_params(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    sa, sb = a["detector"].state_dict(), b["detector"].state_dict()
    return (sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
            and _same(trainer.leaves(a["decoder"]), trainer.leaves(b["decoder"])))


def run(args: argparse.Namespace, cfg: ModelConfig, tokenizer: GPT2Tokenizer,
        device: torch.device,
        log: Callable[[str], None] = lambda m: print(m, file=sys.stderr)) -> Dict[str, Any]:
    tcfg = TrainConfig(batch_size=args.batch, grad_accumulation_steps=1,
                       learning_rate=args.lr, detector_learning_rate=args.lr, seed=0)
    rcfg = RGRGConfig(model=cfg, train=tcfg, mesh=MeshConfig(num_devices=1))
    model = RGRG(cfg=cfg)

    data_rng = np.random.default_rng(0)
    val_rng = np.random.default_rng(10_000)
    size = cfg.detector.image_size
    val_batches = [build_corpus_batch(val_rng, args.batch, tokenizer, args.seq_len, size)
                   for _ in range(args.eval_batches)]

    def batches(n_steps):
        def factory():
            for _ in range(n_steps):
                yield build_corpus_batch(data_rng, args.batch, tokenizer, args.seq_len, size,
                                         with_text=False)
        return factory

    def val_losses(params, stage):
        return EV.validation_losses(model, params, iter(val_batches), stage, tcfg,
                                    lm_budget=args.lm_budget, max_batches=1)

    dec = cfg.decoder
    summary: Dict[str, Any] = {
        "config": {"stage1_steps": args.stage1_steps, "stage2_steps": args.stage2_steps,
                   "stage3_steps": args.stage3_steps, "batch": args.batch,
                   "decoder": {"layers": dec.num_layers, "hidden": dec.hidden_dim,
                               "vocab": dec.vocab_size},
                   "backbone_stages": list(cfg.detector.backbone_stages)},
        "stages": {}}

    def stage_dir(stage):
        return os.path.join(args.run_dir, f"stage{stage}")

    def run_stage(stage, n_steps, init_params):
        t0 = time.time()
        state = train_loop.train(
            model, rcfg, batches(n_steps), stage_dir(stage), stage=stage, num_epochs=1,
            max_steps=None, lm_budget=args.lm_budget,
            val_fn=lambda st: val_losses(st.params, stage),
            evaluate_every=max(n_steps // 2, 1), init_params=init_params, device=device)
        params = state.params
        del state   # the optimizer's moments
        val = val_losses(params, stage)
        last = os.path.join(stage_dir(stage), "last")
        summary["stages"][f"stage{stage}"] = {
            "steps": n_steps,
            "wall_seconds": round(time.time() - t0, 1),
            "final_val_losses": {k: round(v, 4) for k, v in val.items()},
            "checkpoint": last,
        }
        log(f"stage {stage} done in {time.time() - t0:.0f}s: "
            f"{summary['stages'][f'stage{stage}']['final_val_losses']}")
        shutil.rmtree(os.path.join(stage_dir(stage), "best"), ignore_errors=True)
        if not _same_params(load_params(last, cfg, device), params):
            raise RuntimeError(f"{last} does not reload the stage-{stage} params bit for bit")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return params

    # ---- the protocol ----
    p1 = run_stage(1, args.stage1_steps, init_params=None)
    p2 = run_stage(2, args.stage2_steps, init_params={"detector": p1["detector"]})
    del p1
    shutil.rmtree(stage_dir(1))
    p3 = run_stage(3, args.stage3_steps, init_params=p2)
    del p2
    shutil.rmtree(stage_dir(2))

    # ---- final evaluation of the stage-3 params ----
    t0 = time.time()
    artifacts_dir = os.path.join(args.run_dir, "eval_artifacts")
    counting = ClosureCount(model)
    eval_out = EV.evaluate_model(
        counting, p3, iter(val_batches), tokenizer=tokenizer, generate_language=True,
        num_beams=4, max_length=args.seq_len, early_stopping=True, similarity_fn=None,
        artifacts_dir=artifacts_dir, num_figure_images=args.num_figure_images)
    summary["final_eval"] = {
        "wall_seconds": round(time.time() - t0, 1),
        "object_detector": {
            "avg_detections_per_image": eval_out["object_detector"]["avg_detections_per_image"],
            "avg_iou": eval_out["object_detector"]["avg_iou"],
        },
        "region_selection": eval_out["region_selection"],
        "region_abnormal": eval_out["region_abnormal"],
        "sentence": eval_out.get("sentence"),
        "report": eval_out.get("report"),
        "artifacts_dir": artifacts_dir,
        "artifacts": sorted(os.listdir(artifacts_dir)) if os.path.isdir(artifacts_dir) else [],
        "language_generation": {
            "decoded_rows": counting.rows,
            "rows_closed_before_max_length": counting.closed,
            "closed_share": counting.closed / counting.rows if counting.rows else None,
            "row_budgets": counting.row_budgets,
            "decode_seconds": eval_out["language_generation"]["decode_seconds"],
            "cascade": eval_out["language_generation"]["cascade"],
        },
    }
    del p3
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the serving proposal budget on the stage-3 checkpoint ----
    last = summary["stages"]["stage3"]["checkpoint"]
    t0 = time.time()
    budget = {"ckpt": last}
    budget.update(budget_check.certify(
        model, load_params(last, cfg, device), args.budgets, args.budget_batch,
        args.budget_eval_batches, ladder=True, time_detect_batch=args.time_detect))
    budget["wall_seconds"] = round(time.time() - t0, 1)
    summary["proposal_budget"] = budget
    shutil.rmtree(stage_dir(3))
    if args.budget_out:
        os.makedirs(os.path.dirname(args.budget_out) or ".", exist_ok=True)
        with open(args.budget_out, "w") as f:
            json.dump(budget, f, indent=2)
    return summary


def main(argv: Optional[Sequence[str]] = None, cfg: Optional[ModelConfig] = None
         ) -> Dict[str, Any]:
    """cfg: the model config (default: `model_config(tokenizer, --shallow,
    --seq-len)`), e.g. narrower for a test."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    tokenizer = GPT2Tokenizer.dummy()
    cfg = cfg or model_config(tokenizer, args.shallow, args.seq_len)
    summary = run(args, cfg, tokenizer, device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2, default=float)
    print(json.dumps(summary, indent=2, default=float))
    return summary


if __name__ == "__main__":
    main()

"""Train RGRG from split CSVs: the three-stage protocol (the reference's
README_TRAIN_TEST.md).

  stage 1: the object detector alone
  stage 2: + the binary classifiers (pretraining without the LM)
  stage 3: the full model (GPT-2 frozen; uk/uv and the feature transform
           train)

    python -m rgrg_tpu_torch.train --stage 3 --train-csv data/train.csv \\
        --val-csv data/valid.csv --tokenizer-dir gpt2/ --run-dir runs/r1 \\
        [--workers 4] [--device cpu]

Training batches come from RGRGDataset(train=True): the images augmented
on the host (data/transforms.train_transform, no cv2 but to read the
files), shuffled every epoch. Writes <run_dir>/metrics.jsonl and the
checkpoints `best` (each new best validation loss) and `last`, which
`--resume-from` continues and `python -m rgrg_tpu_torch.evaluate
--checkpoint <run_dir>/last` scores. `--init-from-torch` warm-starts from
a reference .pt: a stage-1 detector checkpoint, or a full model. Runs on
the card unless `--device cpu` is given.

Data parallel: cfg.mesh.num_devices ranks (None, the default: every
visible card; one process on the CPU), one per card (core/mesh.launch;
NCCL, or gloo with `--device cpu`; CUDA_VISIBLE_DEVICES narrows the
cards). Each rank works out the mesh, clamped to divide the global batch,
before it loads anything (a rank outside it returns). With `--workers N`
> 0 each rank builds only its rows of every global batch
(RGRGDataset.rank_batches; the ranks agree on unreadable images over a
gloo group of their own, core/mesh.host_mesh), the rows the replicated
loader would give it; `--prefetch` batches of its rows are built ahead.
With `--workers 0` every rank builds the whole global batch on the shared
Generator's stream (the JAX package's workers=0 batches, which cannot be
split) and keeps its rows. train.loop.train computes the global batch's
loss and gradient, and rank 0 validates and writes metrics and
checkpoints. The kernels are built once before the ranks start.
"""

from __future__ import annotations

import argparse
import itertools
import logging
from typing import Any, Dict, Optional

log = logging.getLogger("rgrg_tpu_torch.train")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", type=int, default=3, choices=[1, 2, 3])
    ap.add_argument("--train-csv", required=True)
    ap.add_argument("--val-csv", default=None)
    ap.add_argument("--tokenizer-dir", default=None)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lm-budget", type=int, default=128)
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--init-from-torch", default=None,
                    help="warm-start from a reference .pt (stage-1 detector or full model)")
    ap.add_argument("--workers", type=int, default=0,
                    help="sample-construction threads (DataLoader num_workers analogue); "
                         "over several ranks, > 0 builds only each rank's rows")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches prefetched ahead of the device step (0 = synchronous)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def init_from_torch(path: str, cfg) -> Dict[str, Any]:
    """A reference .pt -> warm-start weights for train.loop.train, in the
    JAX package's layout (numpy): a full model's {"detector", "decoder"}
    when its keys start with "object_detector." (or "module.object_detector."
    for a DataParallel save, which the JAX package's script takes for a
    detector checkpoint and fails on), else a stage-1 detector's
    {"detector"} (its classifiers keep their fresh init). `cfg` is the
    ModelConfig; its backbone stages and decoder depth drive the
    conversion."""
    from rgrg_tpu_torch.core.checkpoint import (convert_detector_checkpoint,
                                                convert_full_checkpoint,
                                                load_torch_checkpoint)
    sd = load_torch_checkpoint(path)
    stages = cfg.detector.backbone_stages
    if any(k.startswith(("object_detector.", "module.object_detector.")) for k in sd):
        return convert_full_checkpoint(sd, num_layers=cfg.decoder.num_layers,
                                       stage_sizes=stages)
    return {"detector": convert_detector_checkpoint(sd, stage_sizes=stages)}


def make_val_fn(model, cfg, val_ds, tok, stage: int, batch_size: int, lm_budget: int):
    """val_fn(state) -> the per-module validation losses over at most 20
    batches ("total" drives the plateau scheduler and the best checkpoint),
    plus, from cfg.train.lm_eval_min_steps on (stages 2-3, with a
    tokenizer), language metrics of evaluate_model over 5 batches at
    max_length 128, as lm_<metric> and lm_report_<metric>."""
    from rgrg_tpu_torch.eval.evaluator import evaluate_model, validation_losses

    def val_fn(state) -> Dict[str, float]:
        out = validation_losses(model, state.params, val_ds.batches(batch_size), stage,
                                cfg.train, lm_budget, max_batches=20)
        if tok is not None and stage >= 2 and int(state.step) >= cfg.train.lm_eval_min_steps:
            # cap the iterator itself: max_language_batches bounds only the
            # generation loop, not the detector pass over the split
            lm = evaluate_model(model, state.params,
                                itertools.islice(val_ds.batches(batch_size), 5), tok,
                                max_language_batches=5, max_length=128)
            for k, v in lm.get("sentence", {}).items():
                if isinstance(v, (int, float)):
                    out[f"lm_{k}"] = float(v)
            for k, v in lm.get("report", {}).items():
                if isinstance(v, (int, float)):
                    out[f"lm_report_{k}"] = float(v)
        return out
    return val_fn


def main(argv=None, cfg=None):
    """Parse `argv` (default sys.argv) and train. `cfg`: the RGRGConfig
    (default RGRGConfig(), the reference's full width). Returns the final
    TrainState; with more than one rank, None (the ranks' states stay in
    their processes; <run_dir>/last holds it)."""
    import torch
    from rgrg_tpu_torch.core.config import RGRGConfig
    from rgrg_tpu_torch.core.device import resolve_device

    args = build_parser().parse_args(argv)
    cfg = cfg or RGRGConfig()
    device = resolve_device(args.device)
    n = cfg.mesh.num_devices
    if n is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n == 1:
        return _train(args, cfg, device)
    from rgrg_tpu_torch.core import mesh
    if device.type == "cuda":
        from rgrg_tpu_torch.ops import kernels
        kernels.build()
    mesh.launch(_train_rank, n, args=(args, cfg), device=device.type)
    return None


def _train_rank(rank: int, args, cfg) -> None:
    """One rank of the data-parallel CLI: the mesh, clamped to the global
    batch as train.loop.train would clamp it, and with `--workers` > 0 the
    loader's gloo group, both built before any loading or thread (every
    rank builds them); a rank outside the mesh returns."""
    from rgrg_tpu_torch.core import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(cfg.mesh.num_devices,
                              batch_size=args.batch_size or cfg.train.batch_size)
    host = mesh_lib.host_mesh(mesh) if args.workers > 0 else None
    if not mesh.member:
        log.info("rank %d is outside the %d-rank mesh", rank, mesh.size)
        return None
    if host is None:
        log.warning("--workers 0 over %d ranks: every rank builds the whole global batch "
                    "(the shared Generator's stream cannot be split); --workers N > 0 "
                    "builds only each rank's rows", mesh.size)
    _train(args, cfg, mesh_lib.rank_device(), mesh, host)


def _train(args, cfg, device, mesh=None, host=None):
    """Train on `device`; over a mesh, this rank's part, its loader
    rank-local when `host` (the loader's gloo group) is given."""
    from rgrg_tpu_torch.core import mesh as mesh_lib
    from rgrg_tpu_torch.data.dataset import RGRGDataset, read_split_csv
    from rgrg_tpu_torch.data.prefetch import prefetched
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
    from rgrg_tpu_torch.train.loop import train

    model = RGRG(cfg=cfg.model)
    batch_size = args.batch_size or cfg.train.batch_size
    init_params: Optional[Dict[str, Any]] = None
    if args.init_from_torch:
        init_params = init_from_torch(args.init_from_torch, cfg.model)

    tok = GPT2Tokenizer.from_dir(args.tokenizer_dir) if args.tokenizer_dir else None
    train_ds = RGRGDataset(read_split_csv(args.train_csv), tok, train=True,
                           seq_len=args.seq_len)

    def train_batches():
        if host is not None:
            return train_ds.rank_batches(
                batch_size, mesh.rank, mesh.size, lambda failed: mesh_lib.gather_objects(
                    failed, host), shuffle=True, workers=args.workers, ahead=args.prefetch)
        it = train_ds.batches(batch_size, shuffle=True, workers=args.workers)
        it = prefetched(it, depth=args.prefetch) if args.prefetch > 0 else it
        return it if mesh is None else (mesh_lib.shard_pytree_batch(b, mesh) for b in it)

    val_fn = None
    if args.val_csv:
        val_ds = RGRGDataset(read_split_csv(args.val_csv), tok, seq_len=args.seq_len)
        val_fn = make_val_fn(model, cfg, val_ds, tok, args.stage, batch_size, args.lm_budget)

    return train(model, cfg, train_batches, args.run_dir, stage=args.stage,
                 num_epochs=args.epochs, val_fn=val_fn, lm_budget=args.lm_budget,
                 resume_from=args.resume_from, max_steps=args.max_steps,
                 init_params=init_params, device=device, mesh=mesh)


if __name__ == "__main__":
    main()

"""The epoch / step loop of the three-stage training protocol, on one device
or data-parallel over the ranks of a process group (core/mesh.py).

  - checkpoints `<run_dir>/best` (each new best validation loss),
    `step_N` (every checkpoint_every mini-steps) and `last`, and resume from
    any of them (`resume_from`): the whole TrainState, bit for bit;
  - ReduceLROnPlateau through `PlateauScheduler`, applied as the
    optimizer's LR scale; optional early stop; `max_steps` mini-steps;
  - the proposal-sampling draws come from a torch.Generator seeded with
    seed + 1 on the params' device, the params from `seed`; dropout draws
    from the device's default generator, seeded with seed + 2;
  - data parallelism as in the JAX package: the mesh is built at the first
    batch from cfg.mesh.num_devices (None: every rank of the process
    group), clamped to divide the batch, and every rank takes the same
    global batches and keeps its rows; or a caller that built the mesh
    before loading (`mesh`, as the train CLI does) hands each rank its
    own rows. The state is replicated from rank 0, and the train step
    computes the global batch's loss and gradient (train/trainer.py).
    Rank 0 alone writes metrics and checkpoints, and
    runs the validation, whose result it broadcasts, so the plateau scale,
    the best checkpoint, early stop and max_steps are decided alike on
    every rank.
Scalars go to `<run_dir>/metrics.jsonl` (utils/logging.MetricWriter).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Iterable, Mapping, Optional

import torch

from rgrg_tpu_torch.core import mesh as mesh_lib
from rgrg_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from rgrg_tpu_torch.core.config import RGRGConfig
from rgrg_tpu_torch.core.convert import load_detector_
from rgrg_tpu_torch.core.device import DeviceLike
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.train import trainer
from rgrg_tpu_torch.utils.logging import MetricWriter

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PlateauScheduler:
    """torch ReduceLROnPlateau(mode="min", threshold_mode="rel") as a state
    machine, with the reference's factor 0.5, patience 5, threshold 1e-3
    and cooldown 5:
      - improvement means val < best * (1 - threshold);
      - during cooldown (after a reduction) bad validations are not counted;
      - reduce when the bad count exceeds patience, then cool down;
      - a reduction smaller than eps is skipped."""
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-3
    cooldown: int = 5
    eps: float = 1e-8
    best: float = float("inf")
    bad_count: int = 0
    cooldown_counter: int = 0
    scale: float = 1.0

    def update(self, val_loss: float) -> float:
        if val_loss < self.best * (1.0 - self.threshold):
            self.best = val_loss
            self.bad_count = 0
        else:
            self.bad_count += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.bad_count = 0
        if self.bad_count > self.patience:
            new_scale = self.scale * self.factor
            if self.scale - new_scale > self.eps:
                self.scale = new_scale
            self.cooldown_counter = self.cooldown
            self.bad_count = 0
        return self.scale


def warm_start_params(params: trainer.Params, init_params: trainer.Params) -> trainer.Params:
    """The stage-(N-1) -> stage-N handoff: each top-level entry of
    init_params replaces the fresh init ("detector": a RegionDetector or its
    state dict, or the JAX package's layout {"params", "batch_stats"} of
    numpy arrays as core/checkpoint's converters give it, loaded into
    params' detector in place, where modules the layout lacks (a stage-1
    checkpoint's classifiers) keep their init; "decoder": a tree of
    tensors or arrays, copied to the params' device). Entries absent from
    init_params keep their init; an unknown entry raises."""
    params = dict(params)
    device = params["decoder"]["wte"]["embedding"].device
    for key, sub in init_params.items():
        if key not in params:
            raise KeyError(f"warm-start entry {key!r} not in model params "
                           f"(have {sorted(params)})")
        if key == "detector" and isinstance(sub, Mapping) and "params" in sub:
            load_detector_(params["detector"], sub, strict=False)
        elif key == "detector":
            state = sub.state_dict() if isinstance(sub, torch.nn.Module) else sub
            params["detector"].load_state_dict(state)
        else:
            params[key] = trainer.tree_map(
                lambda _, t: torch.as_tensor(t).to(device, copy=True), sub)
    return params


def replicate_state(state: trainer.TrainState, mesh: mesh_lib.Mesh) -> trainer.TrainState:
    """Rank 0's params, accumulated gradient and AdamW moments on every
    rank (in place)."""
    opt = state.opt_state
    mesh_lib.replicate_pytree([state.params, opt.acc,
                               [v for st in opt.adamw.state.values() for v in st.values()]],
                              mesh)
    return state


def train(model: RGRG, cfg: RGRGConfig, train_batches: Callable[[], Iterable],
          run_dir: str, stage: int = 3, num_epochs: int = 1,
          val_fn: Optional[Callable[[Any], Any]] = None,
          evaluate_every: Optional[int] = None, lm_budget: int = 128,
          resume_from: Optional[str] = None, checkpoint_every: Optional[int] = None,
          max_steps: Optional[int] = None, init_params: Optional[Any] = None,
          device: DeviceLike = None,
          mesh: Optional[mesh_lib.Mesh] = None) -> trainer.TrainState:
    """train_batches: a factory of a fresh batch iterator per epoch (dicts
    of numpy arrays or tensors). val_fn(state) -> a validation loss, or a
    dict of them whose "total" drives the plateau scheduler and the best
    checkpoint, called every `evaluate_every` mini-steps. init_params:
    warm-start weights (`warm_start_params`). Runs on the card unless
    device="cpu". In a process group (core.mesh.launch) every rank calls
    it alike; a rank that the batch leaves outside the mesh returns None.
    `mesh`: the mesh the caller built (core.mesh.make_mesh, clamped to the
    global batch size) before loading; the batches are then this rank's
    rows of each global batch, which are not cut again. A rank outside
    that mesh must not call train."""
    if mesh is not None and not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the {mesh.size}-rank mesh")
    local_rows = mesh is not None
    tcfg = cfg.train
    main = mesh_lib.process_rank() == 0
    writer = MetricWriter(run_dir) if main else None
    if main:
        writer.write_config(cfg)

    state = trainer.init_train_state(model, tcfg.seed, tcfg, stage=stage, device=device)
    if init_params is not None:
        params = warm_start_params(state.params, init_params)
        state = trainer.TrainState(params, trainer.make_optimizer(params, tcfg, stage),
                                   state.step)
    if resume_from:
        state = load_checkpoint(resume_from, target=state)
        log.info("resumed from %s at step %d", resume_from, state.step)

    # the step (and the mesh, unless given) is built at the first batch, so
    # that the mesh can be clamped to the batch
    step_fn = None
    plateau = PlateauScheduler(factor=tcfg.lr_factor, patience=tcfg.lr_patience,
                               threshold=tcfg.lr_threshold, cooldown=tcfg.lr_cooldown)
    evaluate_every = evaluate_every or tcfg.evaluate_every_k_batches
    best_val = float("inf")
    vals_since_best = 0
    stop_early = False
    dev = state.params["decoder"]["wte"]["embedding"].device
    rng = torch.Generator(device=dev).manual_seed(tcfg.seed + 1)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            torch.cuda.manual_seed(tcfg.seed + 2)
    else:
        torch.manual_seed(tcfg.seed + 2)
    step = state.step

    for epoch in range(num_epochs):
        t_epoch = time.time()
        for batch in train_batches():
            if step_fn is None:
                if mesh is None:
                    mesh = mesh_lib.make_mesh(cfg.mesh.num_devices,
                                              batch_size=int(batch["images"].shape[0]))
                    if not mesh.member:
                        log.info("rank %d is outside the %d-rank mesh", mesh.rank, mesh.size)
                        return None
                replicate_state(state, mesh)
                step_fn = trainer.make_train_step(model, tcfg, stage=stage,
                                                  lm_budget=lm_budget, mesh=mesh)
            rows = batch if local_rows else mesh_lib.shard_pytree_batch(batch, mesh)
            state, losses = step_fn(state, rows, rng)
            step = state.step
            if main and step % 50 == 0:
                writer.write_scalars(step, {f"train/{k}": float(v)
                                            for k, v in losses.items()})
            if val_fn is not None and step % evaluate_every == 0:
                val_out = mesh_lib.broadcast_object(val_fn(state) if main else None, mesh)
                if isinstance(val_out, dict):
                    val_loss = float(val_out.get("total", 0.0))
                    if main:
                        writer.write_scalars(step, {f"val/{k}": float(v)
                                                    for k, v in val_out.items()
                                                    if k != "total"})
                else:
                    val_loss = float(val_out)
                prev_scale = plateau.scale
                scale = plateau.update(val_loss)
                if scale != prev_scale:
                    trainer.set_lr_scale(state.opt_state, scale)
                if main:
                    writer.write_scalars(step, {"val/loss": val_loss,
                                                "train/lr_scale": scale})
                if val_loss < best_val:
                    best_val = val_loss
                    vals_since_best = 0
                    if main:
                        save_checkpoint(os.path.join(run_dir, "best"), state)
                else:
                    vals_since_best += 1
                    if (tcfg.early_stop_patience is not None
                            and vals_since_best > tcfg.early_stop_patience):
                        log.info("early stop: %d validations without a new best "
                                 "(patience %d)", vals_since_best,
                                 tcfg.early_stop_patience)
                        stop_early = True
            if main and checkpoint_every and step % checkpoint_every == 0:
                save_checkpoint(os.path.join(run_dir, f"step_{step}"), state)
            if stop_early or (max_steps and step >= max_steps):
                break
        if main:
            writer.write_scalars(step, {"train/epoch_seconds": time.time() - t_epoch,
                                        "train/epoch": epoch})
        if stop_early or (max_steps and step >= max_steps):
            break

    if main:
        save_checkpoint(os.path.join(run_dir, "last"), state)
        writer.close()
    if mesh is not None:
        mesh_lib.barrier(mesh)   # `last` is on disk before any rank returns
    return state

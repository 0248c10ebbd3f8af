"""Train steps for the three-stage RGRG protocol, on one device or as one
rank of a data-parallel mesh (core/mesh.py).

Stages:
  1: the object detector alone (RPN objectness / box + RoI class / box
     losses), at detector_learning_rate;
  2: detector + both binary classifiers;
  3: the full model with the language model: the GPT-2 base is frozen, its
     uk / uv image projections and the feature-space transform train.
Weighted total: detector 1, selection 5, abnormal 5, LM 2.

The optimizer is torch.optim.AdamW (weight decay on every trainable
tensor) with the JAX package's optax.MultiSteps semantics: gradients are
averaged (Welford's running mean) over grad_accumulation_steps mini-steps
and AdamW steps only on the last; BatchNorm running statistics move on
every mini-step and are buffers, never optimised. Frozen tensors get
requires_grad=False, so no weight gradient is computed for them. An LR
scale (ReduceLROnPlateau's knob) sets each group's lr to base x scale,
which equals optax's scaling of the final updates: AdamW's update is
linear in its lr.

Data parallelism (`make_train_step(mesh=)`) keeps the global batch's math:
under core/mesh.active each rank's losses are its share of the whole
batch's (global BatchNorm statistics, draws at the global shape, losses
over global counts, the LM compacted over the global rows), each rank
backpropagates its share, and the gradients are all-reduced by sum: the
gradient of the global loss, not a mean of per-rank means. AdamW then
runs alike on every rank, so the parameters stay bitwise equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rgrg_tpu_torch.core import mesh as mesh_lib
from rgrg_tpu_torch.core.config import TrainConfig
from rgrg_tpu_torch.core.device import DeviceLike
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.train import assign
from rgrg_tpu_torch.train import losses as L

Params = Dict[str, Any]


def tree_map(fn, tree, path=()):
    """Nested dicts -> the same nesting of fn(key path, leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def leaves(tree) -> List[torch.Tensor]:
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def decoder_trainable_mask(decoder_params: Params) -> Dict[str, Any]:
    """True for uk / uv and the feature transform, False for the frozen
    GPT-2 base; same nesting as the decoder params."""
    return tree_map(lambda path, _: "feature_transform" in path
                     or "uk" in path or "uv" in path, decoder_params)


def trainable_mask(params: Params, stage: int) -> Dict[str, Any]:
    """{"detector": {parameter name: True}, "decoder": nested bools}: every
    detector parameter trains in every stage (BatchNorm statistics are
    buffers, not parameters); the decoder's uk / uv and feature transform
    train from stage 3."""
    mask = {"detector": {name: True for name, _ in params["detector"].named_parameters()},
            "decoder": tree_map(lambda path, _: False, params["decoder"])}
    if stage >= 3:
        mask["decoder"] = decoder_trainable_mask(params["decoder"])
    return mask


def set_trainable_(params: Params, stage: int) -> List[torch.Tensor]:
    """Set requires_grad from `trainable_mask`; returns the trainable
    tensors (detector parameters in module order, then decoder leaves)."""
    mask = trainable_mask(params, stage)
    out = []
    for name, p in params["detector"].named_parameters():
        p.requires_grad_(mask["detector"][name])
        if mask["detector"][name]:
            out.append(p)
    for t, m in zip(leaves(params["decoder"]), leaves(mask["decoder"])):
        t.requires_grad_(m)
        if m:
            out.append(t)
    return out


class Optimizer:
    """AdamW over `tensors` with gradient accumulation and an LR scale.

    `step()` runs after each mini-step's backward: it folds the tensors'
    .grad into the running mean (a tensor without a gradient counts as
    zero) and clears .grad; on every k-th call AdamW steps on the mean
    (so weight decay applies to every trainable tensor, as optax does) and
    the mean restarts. Returns whether AdamW stepped."""

    def __init__(self, tensors: List[torch.Tensor], learning_rate: float,
                 weight_decay: float, accumulation_steps: int = 1):
        self.tensors = list(tensors)
        self.base_lr = float(learning_rate)
        self.k = max(1, int(accumulation_steps))
        self.adamw = torch.optim.AdamW(self.tensors, lr=self.base_lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)
        self.acc = [torch.zeros_like(t) for t in self.tensors]
        self.mini_step = 0
        self.scale = 1.0

    @torch.no_grad()
    def step(self) -> bool:
        n = self.mini_step
        for t, acc in zip(self.tensors, self.acc):
            g = t.grad if t.grad is not None else torch.zeros_like(acc)
            acc.add_((g - acc) / (n + 1))
            t.grad = None
        emit = n == self.k - 1
        if emit:
            for t, acc in zip(self.tensors, self.acc):
                t.grad = acc
            self.adamw.step()
            for t, acc in zip(self.tensors, self.acc):
                t.grad = None
                acc.zero_()
        self.mini_step = (n + 1) % self.k
        return emit

    def set_lr_scale(self, scale: float) -> None:
        self.scale = float(scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.base_lr * self.scale

    def state_dict(self) -> Dict[str, Any]:
        """The AdamW state, the accumulated mean (None between updates,
        when it is all zeros), the mini-step and the LR scale."""
        return {"adamw": self.adamw.state_dict(),
                "acc": self.acc if self.mini_step else None,
                "mini_step": self.mini_step, "scale": self.scale,
                "base_lr": self.base_lr, "k": self.k}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        saved_acc = state["acc"]
        if state["k"] != self.k or (saved_acc is not None
                                    and len(saved_acc) != len(self.acc)):
            raise ValueError("optimizer state was saved for other tensors or "
                             "another accumulation count")
        self.adamw.load_state_dict(state["adamw"])
        for i, acc in enumerate(self.acc):
            if saved_acc is None:
                acc.zero_()
            else:
                acc.copy_(saved_acc[i])
        self.mini_step = int(state["mini_step"])
        self.base_lr = float(state["base_lr"])
        self.set_lr_scale(state["scale"])


def set_lr_scale(opt_state: Optimizer, scale: float) -> Optimizer:
    """Set the LR multiplier (every group's lr = base lr x scale)."""
    opt_state.set_lr_scale(scale)
    return opt_state


def get_lr_scale(opt_state: Optimizer) -> float:
    return opt_state.scale


def make_optimizer(params: Params, tcfg: TrainConfig, stage: int,
                   learning_rate: Optional[float] = None) -> Optimizer:
    """Marks the stage's trainable tensors (requires_grad) and builds the
    optimizer over them: lr detector_learning_rate in stage 1, else
    learning_rate (or the given one)."""
    lr = learning_rate if learning_rate is not None else (
        tcfg.detector_learning_rate if stage == 1 else tcfg.learning_rate)
    return Optimizer(set_trainable_(params, stage), lr, tcfg.weight_decay,
                     tcfg.grad_accumulation_steps)


@dataclasses.dataclass
class TrainState:
    params: Params          # {"detector": RegionDetector, "decoder": tensors}
    opt_state: Optimizer
    step: int = 0           # mini-steps taken


def init_train_state(model: RGRG, seed: int, tcfg: TrainConfig, stage: int = 3,
                     learning_rate: Optional[float] = None,
                     device: DeviceLike = None) -> TrainState:
    """Random params from `seed` (RGRG.init, detector in eval mode) and a
    fresh optimizer for the stage."""
    params = model.init(seed, device=device)
    return TrainState(params, make_optimizer(params, tcfg, stage, learning_rate), 0)


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The array entries of a batch as tensors on `device` (integers as
    int64); other entries (strings, lists) are dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            t = torch.as_tensor(v)
            if not t.is_floating_point() and t.dtype != torch.bool:
                t = t.to(torch.int64)
            out[k] = t.to(device, non_blocking=True)
    return out


def compute_losses(model: RGRG, params: Params, batch: Dict[str, torch.Tensor],
                   rng: assign.Rng, stage: int, tcfg: TrainConfig, lm_budget: int,
                   train: bool = True, mixed_precision: bool = False,
                   remat_decoder: bool = False):
    """Returns (total, loss dict). BatchNorm running statistics update in
    place when train=True.

    train=False gives the validation losses' semantics: BatchNorm on running
    statistics (not updated), no dropout, the test RPN top-n; the proposal
    sampling still draws from `rng`. mixed_precision=True runs the decoder
    forward on bf16 copies of its f32 parameters (the gradient returns to
    the f32 masters); remat_decoder checkpoints each GPT-2 block."""
    det = params["detector"]
    det_losses, aux = det.train_forward(batch["images"], batch["gt_boxes"],
                                        batch["gt_labels"], batch["gt_valid"], rng,
                                        bn_train=train)
    losses = dict(det_losses)
    total = tcfg.loss_weight_detector * sum(det_losses.values())

    if stage >= 2:
        ccfg = model.cfg.classifier
        sel_loss = L.classifier_loss(aux["selection_logits"], batch["region_has_sentence"],
                                     aux["class_detected"], ccfg.selection_pos_weight)
        abn_loss = L.classifier_loss(aux["abnormal_logits"], batch["region_is_abnormal"],
                                     aux["class_detected"], ccfg.abnormal_pos_weight)
        losses["loss_selection"] = sel_loss
        losses["loss_abnormal"] = abn_loss
        total = (total + tcfg.loss_weight_selection * sel_loss
                 + tcfg.loss_weight_abnormal * abn_loss)

    if stage >= 3:
        seq_valid = aux["class_detected"] & batch["region_has_sentence"].to(torch.bool)
        dec_params = params["decoder"]
        if mixed_precision:
            dec_params = tree_map(lambda _, t: t.to(torch.bfloat16)
                                   if t.dtype == torch.float32 else t, dec_params)
        lm = L.lm_loss_selected(dec_params, batch["input_ids"], batch["attention_mask"],
                                aux["region_features"], seq_valid, model.cfg.decoder,
                                lm_budget, dropout=train, remat=remat_decoder)
        losses["loss_lm"] = lm
        total = total + tcfg.loss_weight_lm * lm

    losses["loss_total"] = total
    return total, losses


def make_train_step(model: RGRG, tcfg: TrainConfig, stage: int = 3,
                    lm_budget: int = 128, mixed_precision: bool = False,
                    remat_decoder: bool = False, mesh: Optional[mesh_lib.Mesh] = None):
    """Builds train_step(state, batch, rng) -> (state, losses): one
    mini-step (forward, backward, accumulate; AdamW on every
    grad_accumulation_steps-th), updating `state` in place. `batch` holds
    numpy arrays or tensors; losses are detached tensors on the device.
    With a mesh, `batch` is this rank's rows of the global batch
    (core/mesh.shard_pytree_batch), `rng` is seeded alike on every rank,
    and the losses returned are the global batch's."""

    def train_step(state: TrainState, batch: Dict[str, Any], rng: assign.Rng):
        device = state.params["decoder"]["wte"]["embedding"].device
        with mesh_lib.active(mesh):
            total, losses = compute_losses(model, state.params, batch_to_device(batch, device),
                                           rng, stage, tcfg, lm_budget,
                                           mixed_precision=mixed_precision,
                                           remat_decoder=remat_decoder)
            total.backward()
        mesh_lib.all_reduce_grads_(state.opt_state.tensors, mesh)
        names = list(losses)
        summed = mesh_lib.global_sum(torch.stack([losses[k].detach().float()
                                                  for k in names]), mesh)
        losses = dict(zip(names, summed))
        state.opt_state.step()
        state.step += 1
        return state, {k: v.detach() for k, v in losses.items()}

    return train_step

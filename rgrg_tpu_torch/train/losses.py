"""Training losses, mask-weighted static-shape formulations, batched.

  - RPN: BCE-with-logits objectness over 256 sampled anchors per image +
    smooth-L1 (beta 1/9, summed) over the sampled positives' deltas, each
    divided by the image's sample count, then averaged over images.
  - RoI: CE over 512 sampled (gt-augmented) proposals per image +
    smooth-L1 (beta 1/9, summed) over the positives' matched-class deltas,
    divided by the batch's sample count.
  - selection / abnormal classifiers: BCE-with-logits (pos_weight 2.2 / 6.0)
    averaged over the detected regions.
  - LM: shift-by-one CE ignoring pads, averaged over the valid tokens of the
    valid (detected and sentence-bearing) region sequences.

Every loss is this rank's share of the loss of the mesh's global batch
(core/mesh.current; without a mesh, this process's batch): its sum over this rank's rows divided
by the global count (of images, sampled RoIs, detected regions, valid
tokens), so the ranks' shares add up to the loss of the whole batch and
so do their gradients. The LM compacts the global batch's rows and
decodes this rank's part of them (`lm_loss_selected`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from rgrg_tpu_torch.core import mesh as mesh_lib
from rgrg_tpu_torch.core.config import DetectorConfig
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.ops import boxes as box_ops
from rgrg_tpu_torch.train import assign


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float = 1.0) -> torch.Tensor:
    """Elementwise BCE-with-logits with a positive-class weight."""
    return (pos_weight * targets * _softplus(-logits)
            + (1.0 - targets) * _softplus(logits))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean of x over the True entries of mask (over `dim`, default all)."""
    m = mask.to(x.dtype)
    if dim is None:
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(x * m, dim=dim) / torch.clamp(torch.sum(m, dim=dim), min=1.0)


def batch_masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """masked_mean over the whole batch of the mesh (core/mesh.current):
    this rank's masked sum over the global count."""
    m = mask.to(x.dtype)
    count = mesh_lib.global_sum(torch.sum(m), mesh_lib.current())
    return torch.sum(x * m) / torch.clamp(count, min=1.0)


def image_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the images of a per-image loss [B] of the mesh's global
    batch (core/mesh.current): this rank's sum over the global image
    count."""
    return x.sum() / (x.shape[0] * mesh_lib.current().size)


def _finite(targets: torch.Tensor) -> torch.Tensor:
    """Regression targets with the non-finite ones set to 0. Only rows the
    box loss masks out can have them: an anchor or proposal without a match
    takes gt slot 0, all zeros when the image lacks that region (log(0)),
    and a zero-area padding proposal divides by 0. Masked by a product,
    they would make the loss and its gradient NaN, as in the JAX package
    (ROADMAP section 3); finite targets are kept as they are."""
    return torch.nan_to_num(targets, nan=0.0, posinf=0.0, neginf=0.0)


def rpn_loss(rng: assign.Rng, objectness: torch.Tensor, pred_deltas: torch.Tensor,
             anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
             cfg: DetectorConfig) -> Dict[str, torch.Tensor]:
    """objectness [B, N]; pred_deltas [B, N, 4]; anchors [N, 4];
    gt_boxes [B, G, 4]; gt_valid [B, G]."""
    m = assign.match_anchors(gt_boxes, gt_valid, anchors, cfg.rpn.fg_iou_thresh,
                             cfg.rpn.bg_iou_thresh, allow_low_quality=True)
    labels = torch.where(m.matched_idx >= 0, 1.0, 0.0)
    labels = torch.where(m.matched_idx == assign.BETWEEN, -1.0, labels)
    matched_gt = torch.gather(gt_boxes, 1, torch.clamp(m.matched_idx, min=0)[..., None]
                              .expand(-1, -1, 4))
    reg_targets = _finite(box_ops.encode_boxes(matched_gt, anchors))
    pos, neg = assign.sample_pos_neg(rng, labels, cfg.rpn.batch_size_per_image,
                                     cfg.rpn.positive_fraction)
    sampled = pos | neg
    n_sampled = torch.clamp(sampled.sum(-1), min=1)
    box_l = torch.sum(smooth_l1(pred_deltas, reg_targets, 1.0 / 9.0)
                      * pos[..., None], dim=(1, 2)) / n_sampled
    obj_l = masked_mean(bce_with_logits(objectness, labels), sampled, dim=1)
    # with a fixed sample count per image, the mean of per-image means is
    # the mean over the batch's concatenated samples
    return {"loss_objectness": image_mean(obj_l), "loss_rpn_box_reg": image_mean(box_l)}


class RoISamples(NamedTuple):
    proposals: torch.Tensor    # [B, S, 4] sampled boxes (gt-augmented pool)
    labels: torch.Tensor       # [B, S] int64 class labels (0 = background)
    reg_targets: torch.Tensor  # [B, S, 4]
    sampled: torch.Tensor      # [B, S] bool (False past the available rows)
    pos: torch.Tensor          # [B, S] bool


def select_training_samples(rng: assign.Rng, proposals: torch.Tensor,
                            proposal_valid: torch.Tensor, gt_boxes: torch.Tensor,
                            gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                            cfg: DetectorConfig) -> RoISamples:
    """proposals [B, K, 4] (RPN output), proposal_valid [B, K] (NMS keep),
    gt_* [B, G, ...]. Appends the gt boxes to the proposal pool, matches at
    0.5 / 0.5, samples batch_size_per_image at the positive fraction and
    moves the chosen rows to the front, in pool order: S =
    batch_size_per_image rows."""
    s = cfg.roi.batch_size_per_image
    pool = torch.cat([proposals, gt_boxes.to(proposals.dtype)], dim=1)  # [B, K+G, 4]
    pool_valid = torch.cat([proposal_valid, gt_valid], dim=1)
    m = assign.match_anchors(gt_boxes, gt_valid, pool, cfg.roi.fg_iou_thresh,
                             cfg.roi.bg_iou_thresh, allow_low_quality=False)
    clamped = torch.clamp(m.matched_idx, min=0)
    labels = torch.gather(gt_labels, 1, clamped).to(torch.float32)
    labels = torch.where(m.matched_idx == assign.BELOW_LOW, 0.0, labels)
    labels = torch.where(m.matched_idx == assign.BETWEEN, -1.0, labels)
    labels = torch.where(pool_valid, labels, -1.0)           # padding: discard
    pos_m, neg_m = assign.sample_pos_neg(rng, labels, s, cfg.roi.positive_fraction)
    chosen = pos_m | neg_m
    idx = torch.sort((~chosen).to(torch.int32), dim=1, stable=True).indices[:, :s]
    sampled = torch.gather(chosen, 1, idx)
    sel_props = torch.gather(pool, 1, idx[..., None].expand(-1, -1, 4))
    sel_labels = torch.gather(labels, 1, idx).to(torch.int64)
    matched_gt = torch.gather(gt_boxes, 1, torch.gather(clamped, 1, idx)[..., None]
                              .expand(-1, -1, 4))
    reg_t = _finite(box_ops.encode_boxes(matched_gt, sel_props,
                                         weights=cfg.roi.bbox_reg_weights))
    return RoISamples(sel_props, sel_labels, reg_t, sampled, sampled & (sel_labels > 0))


def fastrcnn_loss(class_logits: torch.Tensor, box_regression: torch.Tensor,
                  samples: RoISamples) -> Dict[str, torch.Tensor]:
    """class_logits [B, S, C]; box_regression [B, S, C*4]."""
    b, s, c = class_logits.shape
    labels = torch.clamp(samples.labels, min=0)
    logp = torch.log_softmax(class_logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    cls_loss = batch_masked_mean(nll, samples.sampled)
    reg = box_regression.reshape(b, s, c, 4)
    picked = torch.gather(reg, 2, labels[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    box_l = torch.sum(smooth_l1(picked, samples.reg_targets, 1.0 / 9.0)
                      * samples.pos[..., None])
    n_sampled = mesh_lib.global_sum(samples.sampled.sum(), mesh_lib.current())
    box_loss = box_l / torch.clamp(n_sampled, min=1)
    return {"loss_classifier": cls_loss, "loss_box_reg": box_loss}


def classifier_loss(logits: torch.Tensor, targets: torch.Tensor,
                    class_detected: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """Weighted BCE over the detected regions; all [B, 29]."""
    return batch_masked_mean(bce_with_logits(logits, targets.to(logits.dtype), pos_weight),
                             class_detected)


def lm_loss_selected(decoder_params, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor, region_features: torch.Tensor,
                     seq_valid: torch.Tensor, cfg, budget: int,
                     dropout: bool = False, remat: bool = False) -> torch.Tensor:
    """LM loss over the valid region sequences, stably compacted to `budget`
    rows. input_ids / attention_mask [B, 29, S]; region_features [B, 29, F];
    seq_valid [B, 29]. Equals the CE over the dynamically filtered batch
    whenever budget >= the valid count. CE is logsumexp minus the picked
    logit (no [N, S, V] log-softmax is materialised).

    The inputs are this rank's images of the mesh (core/mesh.current; one
    process alone is a mesh of one): the global batch's rows are gathered (region features with their gradient),
    compacted to `budget` in the same stable order as on one device, and
    this rank decodes its contiguous part of the compacted rows (dropout
    masks cut from the whole budget's); its summed NLL is divided by the
    global count of valid tokens."""
    mesh = mesh_lib.current()
    input_ids, attention_mask, region_features, seq_valid = (
        mesh_lib.all_gather_rows(t, mesh)
        for t in (input_ids, attention_mask, region_features, seq_valid))
    b, r, s = input_ids.shape
    flat_valid = seq_valid.reshape(b * r)
    idx = torch.sort((~flat_valid).to(torch.int32), stable=True).indices[:budget]
    active = flat_valid[idx]
    mask = attention_mask.reshape(b * r, s)[idx] * active[:, None].to(attention_mask.dtype)
    count = torch.clamp(mask[:, 1:].to(torch.bool).sum(), min=1)
    n = idx.shape[0]
    lo, hi = n * mesh.rank // mesh.size, n * (mesh.rank + 1) // mesh.size
    idx, mask = idx[lo:hi], mask[lo:hi]
    ids = input_ids.reshape(b * r, s)[idx]
    feats = region_features.reshape(b * r, -1)[idx]

    logits = gpt2.forward_full(decoder_params, ids, mask, feats, cfg,
                               dropout=dropout, remat=remat, rows=(lo, n))
    shift_logits = logits[:, :-1, :].to(torch.float32)
    shift_labels = ids[:, 1:].to(torch.int64)
    shift_valid = mask[:, 1:].to(torch.bool)
    lse = torch.logsumexp(shift_logits, dim=-1)
    picked = torch.gather(shift_logits, -1, shift_labels[..., None])[..., 0]
    nll = torch.where(shift_valid, lse - picked, 0.0)
    return torch.sum(nll) / count

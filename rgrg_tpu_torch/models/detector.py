"""Anatomical-region detector: the eval forward and the training forward,
static shapes end to end.

  - the RPN keeps a fixed top-k proposal set per image with a validity mask
    instead of compacting after NMS (ops/nms.py, kernel K1 on the card);
  - RoIAlign runs over 256-proposal chunks (ops/roi_align.py, kernel K2 on
    the card) into the TwoMLP box head and the class/box predictor;
  - top-1-per-class decoding is an argmax/gather over [B, K, 29] scores;
  - the region-selection and region-abnormal classifiers run in the same
    forward; "nothing selected" is an all-False `selected_regions` mask;
  - `train_forward` computes the RPN and RoI losses, running the RoI head on
    the sampled gt-augmented proposals (train/losses.py); its gradient
    reaches the backbone through RoIAlign's backward (ops/roi_align.py).

Ties break by the lower index everywhere, as in the reference: the top-k
keeps lax.top_k's order (ops/topk.py), the compactions are stable sorts,
and argmax returns the first maximum.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.core.config import DetectorConfig, RPNConfig
from rgrg_tpu_torch.core.device import dtype_of
from rgrg_tpu_torch.models.heads import (BinaryClassifierMLP, FastRCNNPredictor,
                                         RPNHead, TwoMLPHead)
from rgrg_tpu_torch.models.layers import Linear
from rgrg_tpu_torch.models.resnet import ResNetBackbone
from rgrg_tpu_torch.ops import anchors as anchors_lib
from rgrg_tpu_torch.ops import boxes as box_ops
from rgrg_tpu_torch.ops.nms import nms_keep_mask
from rgrg_tpu_torch.ops.roi_align import roi_align
from rgrg_tpu_torch.ops.topk import stable_topk
from rgrg_tpu_torch.train import assign
from rgrg_tpu_torch.train import losses as L


def filter_proposals(proposals: torch.Tensor, objectness: torch.Tensor,
                     rpn: RPNConfig, image_size: int, train: bool = False):
    """Batched static-shape RPN filter: top-k by objectness (k =
    rpn.pre_nms_top_n(train)) -> clip -> small-box mask -> NMS (one kernel
    launch for the batch on the card).

    proposals [B, N, 4]; objectness [B, N] logits, both f32.
    Returns (boxes [B, K, 4] score-sorted, keep [B, K] bool, scores [B, K]).
    """
    k = min(rpn.pre_nms_top_n(train), objectness.shape[-1])
    scores, idx = stable_topk(objectness, k)
    boxes = torch.gather(proposals, 1, idx[..., None].expand(-1, -1, 4))
    boxes = box_ops.clip_boxes_to_image(boxes, image_size, image_size)
    valid = box_ops.remove_small_boxes_mask(boxes, rpn.min_box_size)
    keep = nms_keep_mask(boxes.contiguous(), valid.contiguous(), rpn.nms_thresh)
    return boxes, keep, scores


def top1_per_class(class_logits: torch.Tensor, valid: torch.Tensor,
                   num_regions: int = C.NUM_REGIONS) -> Dict[str, torch.Tensor]:
    """class_logits [B, K, 1+R] (col 0 background), valid [B, K] bool ->
    class_detected [B, R], top_idx [B, R] (0 when undetected), top_scores."""
    pred_scores = torch.softmax(class_logits, dim=-1)[..., 1:]       # [B,K,R]
    pred_classes = torch.argmax(pred_scores, dim=-1)                 # [B,K]
    onehot = F.one_hot(pred_classes, num_regions).to(pred_scores.dtype)
    onehot = onehot * valid[..., None].to(pred_scores.dtype)
    masked = pred_scores * onehot
    return {"class_detected": onehot.sum(dim=1) > 0,
            "top_idx": torch.argmax(masked, dim=1),
            "top_scores": masked.max(dim=1).values}


def budget_order(keep: torch.Tensor, budget: int) -> torch.Tensor:
    """The proposals [B, budget] an inference_proposal_budget keeps: the
    NMS survivors moved to the front in score order, first `budget` slots.
    Slot 0 stays the top-ranked proposal even where NMS's small-box rule
    dropped it, since an undetected region takes proposal 0's box (top_idx
    0): a budget above every image's survivors (or at them, where the top
    proposal survived) then gives the unbudgeted detections."""
    rank = (~keep).to(torch.int32)
    rank[:, 0] = 0
    return torch.sort(rank, dim=1, stable=True).indices[:, :budget]


class RegionDetector(nn.Module):
    """Backbone + RPN + RoI heads + the two binary-classifier heads.
    Parameters are f32; convs and dense layers compute in cfg.dtype."""

    def __init__(self, cfg: DetectorConfig = DetectorConfig(),
                 device: Optional[torch.device] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        p = cfg.roi.output_size
        self.backbone = ResNetBackbone(cfg.backbone_stages, in_channels=1,
                                       dtype=self.dtype, device=device)
        self.rpn_head = RPNHead(C.BACKBONE_CHANNELS,
                                cfg.anchors.num_anchors_per_location,
                                device=device)
        self.box_head = TwoMLPHead(p * p * C.BACKBONE_CHANNELS,
                                   cfg.roi.representation_size, device=device)
        self.box_predictor = FastRCNNPredictor(cfg.roi.representation_size,
                                               cfg.num_classes, device=device)
        self.dim_reduction = Linear(C.BACKBONE_CHANNELS, C.REGION_FEATURE_DIM,
                                    device=device)
        self.selection_classifier = BinaryClassifierMLP(
            C.REGION_FEATURE_DIM, device=device)
        self.abnormal_classifier = BinaryClassifierMLP(
            C.REGION_FEATURE_DIM, device=device)
        self.register_buffer(
            "anchors", torch.from_numpy(anchors_lib.grid_anchors(cfg.anchors).copy()
                                        ).to(device), persistent=False)

    def rpn_forward(self, feats: torch.Tensor, train: bool = False):
        """C5 [B, 16, 16, 2048] -> (boxes [B, K, 4], keep [B, K],
        (objectness [B, N], deltas [B, N, 4], anchors [N, 4])): the proposals
        (K = rpn.pre_nms_top_n(train)), decoded from the detached RPN
        outputs, and the raw f32 outputs the RPN loss reads."""
        objectness, deltas = self.rpn_head(feats)
        # box math always in f32: bf16 (~2 px at coordinate 512) would
        # corrupt proposal geometry and NMS decisions
        objectness = objectness.to(torch.float32)
        deltas = deltas.to(torch.float32)
        proposals = box_ops.decode_boxes(deltas.detach(), self.anchors)[..., 0, :]
        boxes, keep, _ = filter_proposals(proposals, objectness.detach(),
                                          self.cfg.rpn, self.cfg.image_size, train)
        return boxes, keep, (objectness, deltas, self.anchors)

    def rpn_proposals(self, feats: torch.Tensor):
        """C5 [B, 16, 16, 2048] -> (boxes [B, K, 4], keep [B, K]) at the test
        top-n."""
        boxes, keep, _ = self.rpn_forward(feats)
        return boxes, keep

    def _pool(self, feats: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        return roi_align(feats, boxes.contiguous(),
                         output_size=self.cfg.roi.output_size,
                         spatial_scale=1.0 / C.BACKBONE_STRIDE,
                         sampling_ratio=self.cfg.roi.sampling_ratio)

    def roi_forward(self, feats: torch.Tensor, boxes: torch.Tensor):
        """RoIAlign + box head over [B, K, 4] boxes in chunks of
        cfg.roi.proposal_chunk, so the pooled [B, chunk, 8, 8, 2048] f32 map
        never exists for all K at once. A short last chunk is padded with
        empty boxes to the chunk's size, so every chunk's products have one
        shape: the GEMM library picks its algorithm, and so its rounding, by
        shape, and a proposal's outputs then do not depend on how many run
        with it (under an inference_proposal_budget of at least one chunk,
        the kept proposals get the unbudgeted logits bit for bit).
        Returns (class_logits [B,K,30], box_regression [B,K,120],
        box_features [B,K,2048] bin-averaged), all f32."""
        k = boxes.shape[1]
        chunk = min(self.cfg.roi.proposal_chunk, k)
        fc6_kernel = self.box_head.fc6.kernel.to(self.dtype)
        outs = []
        for start in range(0, k, chunk):
            part = boxes[:, start:start + chunk]
            n = part.shape[1]
            if n < chunk:
                part = F.pad(part, (0, 0, 0, chunk - n))
            pooled = self._pool(feats, part)
            box_vecs = self.box_head(pooled, self.dtype, fc6_kernel)
            cls, reg = self.box_predictor(box_vecs)
            outs.append((cls[:, :n].to(torch.float32), reg[:, :n].to(torch.float32),
                         pooled[:, :n].mean(dim=(2, 3)).to(torch.float32)))
        return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(3))

    def region_features_from_boxes(self, feats: torch.Tensor,
                                   boxes: torch.Tensor) -> torch.Tensor:
        """User boxes [B, N, 4] -> region features [B, N, 1024] f32,
        bypassing the RPN."""
        pooled = self._pool(feats, boxes)
        return self.dim_reduction(pooled.mean(dim=(2, 3)).to(self.dtype)
                                  ).to(torch.float32)

    def train_forward(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                      rng: assign.Rng, bn_train: bool = True):
        """Training forward: losses and per-region features. The RoI head
        runs on the batch_size_per_image SAMPLED proposals (gt-augmented),
        and top-1 per class, the region features and both classifiers come
        from those samples.

        bn_train=True: BatchNorm on batch statistics (updating the running
        ones) and the training RPN top-n (2000). bn_train=False: the
        eval-with-targets semantics of the validation losses: running
        statistics, the test top-n (1000), sampling still on. The module's
        own mode is restored afterwards.

        gt_boxes [B, G, 4]; gt_labels [B, G] int (1..29); gt_valid [B, G];
        rng: the sampling draws (train/assign.uniform): the RPN's positive
        then negative keys, then the RoI head's.
        Returns (losses dict, aux dict with region_features [B, 29, 1024],
        class_detected [B, 29], selection_logits, abnormal_logits)."""
        was_training = self.training
        self.train(bn_train)
        try:
            feats = self.backbone(images)
        finally:
            self.train(was_training)
        boxes, keep, (objectness, deltas, anchors) = self.rpn_forward(feats, bn_train)
        gt_boxes = gt_boxes.to(torch.float32)
        losses = L.rpn_loss(rng, objectness, deltas, anchors, gt_boxes, gt_valid, self.cfg)
        samples = L.select_training_samples(rng, boxes, keep, gt_boxes, gt_labels,
                                            gt_valid, self.cfg)
        class_logits, box_regression, box_features = self.roi_forward(
            feats, samples.proposals)
        losses.update(L.fastrcnn_loss(class_logits, box_regression, samples))

        sel = top1_per_class(class_logits, samples.sampled)
        bidx = torch.arange(feats.shape[0], device=feats.device)[:, None]
        top_features = box_features[bidx, sel["top_idx"]]
        region_features = self.dim_reduction(top_features.to(self.dtype))
        aux = {"region_features": region_features,
               "class_detected": sel["class_detected"],
               "selection_logits": self.selection_classifier(region_features),
               "abnormal_logits": self.abnormal_classifier(region_features)}
        return losses, aux

    def forward(self, images: torch.Tensor,
                logit_threshold: float = -1.0) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 1] normalized NHWC -> dict of
        top_region_boxes [B,29,4], top_scores [B,29], class_detected [B,29],
        region_features [B,29,1024] (compute dtype), selection_logits,
        abnormal_logits [B,29], selected_regions, predicted_abnormal [B,29]."""
        feats = self.backbone(images)
        boxes, keep = self.rpn_proposals(feats)

        budget = self.cfg.roi.inference_proposal_budget
        if budget is not None and budget < boxes.shape[1]:
            order = budget_order(keep, budget)
            boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
            keep = torch.gather(keep, 1, order)

        class_logits, box_regression, box_features = self.roi_forward(feats, boxes)

        sel = top1_per_class(class_logits, keep)
        class_detected, top_idx = sel["class_detected"], sel["top_idx"]

        decoded = box_ops.decode_boxes(box_regression, boxes,
                                       weights=self.cfg.roi.bbox_reg_weights)
        decoded = box_ops.clip_boxes_to_image(decoded, self.cfg.image_size,
                                              self.cfg.image_size)
        decoded = decoded[..., 1:, :]                                 # [B,K,29,4]
        b = boxes.shape[0]
        bidx = torch.arange(b, device=boxes.device)[:, None]
        ridx = torch.arange(C.NUM_REGIONS, device=boxes.device)[None, :]
        top_boxes = decoded[bidx, top_idx, ridx]                      # [B,29,4]

        top_features = box_features[bidx, top_idx]                    # [B,29,2048]
        region_features = self.dim_reduction(top_features.to(self.dtype))

        selection_logits = self.selection_classifier(region_features)
        abnormal_logits = self.abnormal_classifier(region_features)
        return {
            "top_region_boxes": top_boxes,
            "top_scores": sel["top_scores"],
            "class_detected": class_detected,
            "region_features": region_features,
            "selection_logits": selection_logits,
            "abnormal_logits": abnormal_logits,
            "selected_regions": (selection_logits > logit_threshold) & class_detected,
            "predicted_abnormal": abnormal_logits > logit_threshold,
        }

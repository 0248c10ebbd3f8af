"""Anatomical-region detector, eval forward, static shapes end to end.

  - the RPN keeps a fixed top-k proposal set per image with a validity mask
    instead of compacting after NMS (ops/nms.py, kernel K1 on the card);
  - RoIAlign runs over 256-proposal chunks (ops/roi_align.py, kernel K2 on
    the card) into the TwoMLP box head and the class/box predictor;
  - top-1-per-class decoding is an argmax/gather over [B, K, 29] scores;
  - the region-selection and region-abnormal classifiers run in the same
    forward; "nothing selected" is an all-False `selected_regions` mask.

Ties break by the lower index everywhere, as in the reference: the top-k is
a stable descending sort, the compactions stable sorts, and argmax returns
the first maximum.
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


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last dim, ties broken by the lower index
    (lax.top_k's order; torch.topk promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def filter_proposals(proposals: torch.Tensor, objectness: torch.Tensor,
                     rpn: RPNConfig, image_size: int):
    """Batched static-shape RPN filter: top-k by objectness -> clip ->
    small-box mask -> NMS (one kernel launch for the batch on the card).

    proposals [B, N, 4]; objectness [B, N] logits, both f32.
    Returns (boxes [B, K, 4] score-sorted, keep [B, K] bool, scores [B, K]).
    """
    k = min(rpn.pre_nms_top_n_test, objectness.shape[-1])
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

    def rpn_proposals(self, feats: torch.Tensor):
        """C5 [B, 16, 16, 2048] -> (boxes [B, K, 4], keep [B, K])."""
        objectness, deltas = self.rpn_head(feats)
        # box math always in f32: bf16 (~2 px at coordinate 512) would
        # corrupt proposal geometry and NMS decisions
        objectness = objectness.to(torch.float32)
        deltas = deltas.to(torch.float32)
        proposals = box_ops.decode_boxes(deltas, self.anchors)[..., 0, :]
        boxes, keep, _ = filter_proposals(proposals, objectness, self.cfg.rpn,
                                          self.cfg.image_size)
        return boxes, keep

    def _pool(self, feats: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        return roi_align(feats, boxes.contiguous(),
                         output_size=self.cfg.roi.output_size,
                         spatial_scale=1.0 / C.BACKBONE_STRIDE,
                         sampling_ratio=self.cfg.roi.sampling_ratio)

    def roi_forward(self, feats: torch.Tensor, boxes: torch.Tensor):
        """RoIAlign + box head over [B, K, 4] boxes in chunks of
        cfg.roi.proposal_chunk, so the pooled [B, chunk, 8, 8, 2048] f32 map
        never exists for all K at once.
        Returns (class_logits [B,K,30], box_regression [B,K,120],
        box_features [B,K,2048] bin-averaged), all f32."""
        k = boxes.shape[1]
        chunk = min(self.cfg.roi.proposal_chunk, k)
        fc6_kernel = self.box_head.fc6.kernel.to(self.dtype)
        outs = []
        for start in range(0, k, chunk):
            pooled = self._pool(feats, boxes[:, start:start + chunk])
            box_vecs = self.box_head(pooled, self.dtype, fc6_kernel)
            cls, reg = self.box_predictor(box_vecs)
            outs.append((cls.to(torch.float32), reg.to(torch.float32),
                         pooled.mean(dim=(2, 3)).to(torch.float32)))
        return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(3))

    def region_features_from_boxes(self, feats: torch.Tensor,
                                   boxes: torch.Tensor) -> torch.Tensor:
        """User boxes [B, N, 4] -> region features [B, N, 1024] f32,
        bypassing the RPN."""
        pooled = self._pool(feats, boxes)
        return self.dim_reduction(pooled.mean(dim=(2, 3)).to(self.dtype)
                                  ).to(torch.float32)

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
            # survivors to the front, score order kept, first `budget` slots
            order = torch.sort((~keep).to(torch.int32), dim=1,
                               stable=True).indices[:, :budget]
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

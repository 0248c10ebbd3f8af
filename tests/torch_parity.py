"""Input selection for parity checks of the PyTorch port on random weights.

A random network has near-ties (two objectness scores 4e-6 apart) while two
implementations of the same f32 math (another library, another device)
disagree by ~3e-6, so a discrete decision on such a tie may go either way.
Parity checks therefore run on the first seeded input whose every decision
clears that noise by ~10x. Used by tests/test_torch_{detector,pipeline}.py
and by chip_smoke.py's card-vs-CPU reference phase; imports only torch and
rgrg_tpu_torch.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from rgrg_tpu_torch.core.config import DecoderConfig
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.models.detector import RegionDetector, stable_topk, top1_per_class
from rgrg_tpu_torch.ops.nms import pairwise_iou

# least margin of each discrete decision for a parity check between two f32
# implementations (~10x their observed disagreement of ~3e-6)
PARITY_MARGINS = {"objectness": 3e-5, "iou": 1e-3, "class": 1e-4,
                  "region": 1e-4, "selection": 1e-3}


@torch.no_grad()
def decision_margins(det: RegionDetector, images: torch.Tensor,
                     logit_threshold: float = -1.0) -> dict:
    """Smallest gap of every discrete decision of the detector on `images`:
    the objectness order over the top-k+1, IoU against the NMS threshold,
    the best vs second class of each kept proposal, the best vs second
    proposal of each detected region, and the selection logit against its
    threshold."""
    cfg = det.cfg
    feats = det.backbone(images)
    obj, _ = det.rpn_head(feats)
    v, _ = stable_topk(obj.float(), cfg.rpn.pre_nms_top_n_test + 1)
    boxes, keep = det.rpn_proposals(feats)
    iou = (pairwise_iou(boxes) - cfg.rpn.nms_thresh).abs().nan_to_num(1.0)
    cls, _, _ = det.roi_forward(feats, boxes)
    probs = torch.softmax(cls, -1)[..., 1:]
    top2 = probs.topk(2, dim=-1).values
    sel = top1_per_class(cls, keep)
    onehot = torch.nn.functional.one_hot(probs.argmax(-1), probs.shape[-1]) * keep[..., None]
    masked = (probs * onehot).transpose(1, 2)                     # [B, R, K]
    reg2 = masked.topk(2, dim=-1).values
    region_gap = (reg2[..., 0] - reg2[..., 1])[sel["class_detected"]]
    out = det(images, logit_threshold=logit_threshold)
    sel_gap = (out["selection_logits"] - logit_threshold).abs()[out["class_detected"]]
    return {"objectness": (v[:, :-1] - v[:, 1:]).min().item(),
            "iou": iou.min().item(),
            "class": (top2[..., 0] - top2[..., 1])[keep].min().item(),
            "region": region_gap.min().item() if region_gap.numel() else 1.0,
            "selection": sel_gap.min().item() if sel_gap.numel() else 1.0}


def has_parity_margins(det: RegionDetector, images: torch.Tensor) -> bool:
    """True when every decision on `images` clears PARITY_MARGINS."""
    m = decision_margins(det, images)
    return all(m[k] >= v for k, v in PARITY_MARGINS.items())


@torch.no_grad()
def greedy_logit_margin(params: Dict[str, Any], image_features: torch.Tensor,
                        cfg: DecoderConfig, max_length: int) -> float:
    """Least top-1 vs top-2 logit gap over the greedy path of every row:
    how close any greedy choice came to flipping."""
    logits, cache = gpt2.prefill(params, image_features, cfg.bos_token_id,
                                 max_length, cfg)
    gaps = []
    for t in range(max_length - 1):
        top2 = logits.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).min().item())
        if t < max_length - 2:
            logits, cache = gpt2.decode_step(params, logits.argmax(-1), t, cache, cfg)
    return min(gaps)

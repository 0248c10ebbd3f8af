"""Input selection for parity checks of the PyTorch port on random weights.

A random network has near-ties (two objectness scores 4e-6 apart) while two
implementations of the same f32 math (another library, another device)
disagree by ~3e-6, so a discrete decision on such a tie may go either way.
Parity checks therefore run on the first seeded input whose every decision
clears that noise by ~10x (beam search: every score comparison it makes,
`beam_score_margin`; a whole evaluation input: `image_with_margins`).
Used by tests/test_torch_{detector,pipeline,beam,evaluator,train_model}.py
and by chip_smoke.py's card-vs-CPU reference phases (`training_margins`
for a training step's decisions), which also share the
evaluation batches built here (`WORDS`, `eval_batches`); imports only
numpy, torch and rgrg_tpu_torch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from rgrg_tpu_torch.core.config import DecoderConfig
from rgrg_tpu_torch.decode import beam
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.models.detector import RegionDetector, budget_order, top1_per_class
from rgrg_tpu_torch.ops.boxes import box_iou
from rgrg_tpu_torch.ops.nms import pairwise_iou
from rgrg_tpu_torch.ops.topk import stable_topk
from rgrg_tpu_torch.train import losses as train_losses

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
    threshold. The class and region gaps are over the proposals the RoI
    head sees: under an inference_proposal_budget, the compacted ones."""
    cfg = det.cfg
    feats = det.backbone(images)
    obj, _ = det.rpn_head(feats)
    v, _ = stable_topk(obj.float(), cfg.rpn.pre_nms_top_n_test + 1)
    boxes, keep = det.rpn_proposals(feats)
    iou = (pairwise_iou(boxes) - cfg.rpn.nms_thresh).abs().nan_to_num(1.0)
    budget = cfg.roi.inference_proposal_budget
    if budget is not None and budget < boxes.shape[1]:
        # the RoI head's proposals under a budget, as RegionDetector.forward
        # compacts them
        order = budget_order(keep, budget)
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        keep = torch.gather(keep, 1, order)
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


@torch.no_grad()
def training_margins(det: RegionDetector, images: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                     roi_draws: Sequence[np.ndarray], bn_train: bool = True) -> dict:
    """Smallest gap of every discrete decision of `det.train_forward` on a
    batch, with the RoI sampling fed `roi_draws` (its positive then negative
    keys): the objectness order over the top-k+1, IoU against the NMS
    threshold, each proposal's IoU with each gt against the RoI matching
    threshold and its best vs second gt, and the top-1-per-class choices over
    the sampled proposals (best vs second class of a sampled row, best vs
    second row of a detected region). The anchor matching of the RPN loss
    sees only exact inputs and needs no margin. Running statistics are left
    as they were."""
    cfg = det.cfg
    saved = {k: v.clone() for k, v in det.named_buffers()}
    was_training = det.training
    det.train(bn_train)
    try:
        feats = det.backbone(images)
    finally:
        det.train(was_training)
        for k, v in det.named_buffers():
            v.copy_(saved[k])
    boxes, keep, (obj, _, _) = det.rpn_forward(feats, bn_train)
    v, _ = stable_topk(obj, cfg.rpn.pre_nms_top_n(bn_train) + 1)
    nms_gap = (pairwise_iou(boxes) - cfg.rpn.nms_thresh).abs().nan_to_num(1.0)
    iou = box_iou(gt_boxes, boxes).masked_fill(~gt_valid[..., None], -1.0)   # [B, G, K]
    live = gt_valid[..., None] & keep[:, None, :]
    match_gap = (iou - cfg.roi.fg_iou_thresh).abs()[live]
    best2 = iou.topk(2, dim=1).values                                      # [B, 2, K]
    matched = (best2[:, 0] >= cfg.roi.fg_iou_thresh) & keep
    order_gap = (best2[:, 0] - best2[:, 1])[matched]
    samples = train_losses.select_training_samples(iter(roi_draws), boxes, keep, gt_boxes,
                                                   gt_labels, gt_valid, cfg)
    cls, _, _ = det.roi_forward(feats, samples.proposals)
    probs = torch.softmax(cls, -1)[..., 1:]
    top2 = probs.topk(2, dim=-1).values
    sel = top1_per_class(cls, samples.sampled)
    onehot = (torch.nn.functional.one_hot(probs.argmax(-1), probs.shape[-1])
              * samples.sampled[..., None])
    reg2 = (probs * onehot).transpose(1, 2).topk(2, dim=-1).values
    region_gap = (reg2[..., 0] - reg2[..., 1])[sel["class_detected"]]

    def least(t):
        return t.min().item() if t.numel() else 1.0
    return {"objectness": (v[:, :-1] - v[:, 1:]).min().item(), "iou": nms_gap.min().item(),
            "match": least(match_gap), "match_order": least(order_gap),
            "class": least((top2[..., 0] - top2[..., 1])[samples.sampled]),
            "region": least(region_gap)}


TRAINING_MARGINS = {"objectness": 3e-5, "iou": 1e-3, "match": 1e-3, "match_order": 1e-3,
                    "class": 1e-4, "region": 1e-4}


def has_parity_margins(det: RegionDetector, images: torch.Tensor) -> bool:
    """True when every decision on `images` clears PARITY_MARGINS."""
    m = decision_margins(det, images)
    return all(m[k] >= v for k, v in PARITY_MARGINS.items())


@torch.no_grad()
def greedy_logit_margin(params: Dict[str, Any], image_features: torch.Tensor,
                        cfg: DecoderConfig, max_length: int,
                        cache_dtype=None) -> float:
    """Least top-1 vs top-2 logit gap over the greedy path of every row:
    how close any greedy choice came to flipping."""
    logits, cache = gpt2.prefill(params, image_features, cfg.bos_token_id,
                                 max_length, cfg, cache_dtype=cache_dtype)
    gaps = []
    for t in range(max_length - 1):
        top2 = logits.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).min().item())
        if t < max_length - 2:
            logits, cache = gpt2.decode_step(params, logits.argmax(-1), t, cache, cfg)
    return min(gaps)


@torch.no_grad()
def beam_score_margin(params: Dict[str, Any], image_features: Optional[torch.Tensor],
                      cfg: DecoderConfig, max_length: int, num_beams: int,
                      early_stopping: bool, length_penalty: float = 1.0,
                      cache_dtype=None, batch: Optional[int] = None) -> float:
    """Least gap of every score comparison a beam decode makes (the port's
    beam search, replayed step by step), i.e. how close any decision came
    to flipping:
      - the joint top-(2K+1) candidate scores of each open item, adjacent
        pairs: the top-2K boundary and the order that picks the first K
        non-EOS beams and the EOS hypotheses ranked < K;
      - all hypotheses an item's finished pool ever compared (EOS
        candidates it took in, and the live beams finalize adds), adjacent
        pairs after sorting: the pool's top-K merge and finalize's argmax;
      - with early_stopping=False, the worst finished score against the
        best live score once the pool is full (the `done` rule).
    image_features=None decodes `batch` rows of vanilla GPT-2 (no_image)."""
    k = num_beams
    no_image = image_features is None
    b = batch if no_image else image_features.shape[0]
    logits, cache = gpt2.prefill(params, None if no_image else
                                 image_features.repeat_interleave(k, dim=0),
                                 cfg.bos_token_id, max_length, cfg,
                                 cache_dtype=cache_dtype, batch=b * k)
    t_total = cache["k"].shape[3]
    cache = gpt2.cache_to_beam_layers(cache)
    anc = torch.arange(k, dtype=torch.int32, device=logits.device)[None, :, None].expand(
        b, k, t_total).contiguous()
    state = beam.init_state(b, k, max_length, cfg, logits.device)
    pooled = [[] for _ in range(b)]
    gaps = []
    cur_len = 1
    while True:
        # the exact joint top-(2K+1): each lane's top 2K+1, then merged
        lse = torch.logsumexp(logits.float(), dim=-1)
        vals, idx = stable_topk(logits.float(), 2 * k + 1)
        cand = (vals - lse[:, None] + state["beam_scores"].reshape(-1, 1)).reshape(b, -1)
        top, pos = stable_topk(cand, 2 * k + 1)
        toks = torch.gather(idx.reshape(b, -1), 1, pos)
        lp = beam.length_penalty_divisor(cur_len, length_penalty)
        open_ = ~state["done"]
        gaps += (top[:, :-1] - top[:, 1:]).min(dim=1).values[open_].tolist()
        for i in range(b):
            if open_[i]:
                pooled[i] += [s / lp for s, t in zip(top[i, :k].tolist(), toks[i, :k].tolist())
                              if t == cfg.eos_token_id]
        new_beam, tok, state = beam.process(logits, state, cur_len, k, cfg,
                                            length_penalty, early_stopping)
        f = state["f_scores"]
        if not early_stopping:
            full = torch.isfinite(f).all(dim=1) & open_
            gaps += (f.min(dim=1).values - top[:, 0] / lp)[full].abs().tolist()
        anc = beam.reorder_ancestry(anc, new_beam, cur_len + 1)
        cur_len += 1
        if cur_len >= max_length or bool(state["done"].all()):
            break
        logits, cache = gpt2.decode_step_beam(params, tok, cur_len - 2, cache, anc, cfg,
                                              no_image=no_image)
    lp = beam.length_penalty_divisor(cur_len, length_penalty)
    for i in range(b):
        if not state["done"][i]:
            pooled[i] += (state["beam_scores"][i] / lp).tolist()
        s = sorted(pooled[i], reverse=True)
        gaps += [x - y for x, y in zip(s, s[1:])]
    return min(gaps)


# ---------------------------------------------------------------- evaluation

# report words: the small tokenizers of the evaluation checks give id i + 1
# to " " + WORDS[i] ("." without the space), and reference phrases use them
WORDS = ["the", "lungs", "are", "clear", "heart", "size", "is", "normal", "no",
         "pleural", "effusion", "pneumothorax", "There", "mild", "cardiomegaly", "left",
         "right", "lower", "upper", "lobe", "opacity", "atelectasis", "unchanged",
         "stable", "mediastinal", "contours", "within", "limits", "small", "bilateral",
         "effusions", "focal", "consolidation", "seen", "not", "acute", "process",
         "osseous", "structures", "intact", "silhouette", "enlarged", "hilar", "lung",
         "volumes", "low", "apical", "zone", "."]


def image_with_margins(params: Dict[str, Any], cfg, slot: int, max_length: int,
                       rungs: Sequence[int], min_gap: float, num_beams: int = 4,
                       seeds: int = 64) -> np.ndarray:
    """The first seeded normalised uint8-like 512x512 image [1, 512, 512, 1]
    (as the eval transform normalises) whose detector decisions, and greedy
    (at max_length) and beam (at each rung's length) decisions on its
    selected regions, clear two implementations' f32 disagreement by
    `min_gap`. Decisions are per image and per row, so images picked one
    by one keep their margins in a batch."""
    from rgrg_tpu_torch.models.full_model import RGRG
    model = RGRG(cfg)
    for seed in range(seeds):
        pixels = np.random.default_rng([slot, seed]).integers(0, 256, (1, 512, 512, 1))
        image = ((pixels - 0.471 * 255) / (0.302 * 255)).astype(np.float32)
        x = torch.from_numpy(image)
        if not has_parity_margins(params["detector"], x):
            continue
        det = model.detect(params, x)
        feats = det["region_features"][det["selected_regions"]]
        if (feats.shape[0]
                and greedy_logit_margin(params["decoder"], feats, cfg.decoder,
                                        max_length) >= min_gap
                and all(beam_score_margin(params["decoder"], feats, cfg.decoder, n,
                                          num_beams, True) >= min_gap for n in rungs)):
            return image
    raise AssertionError(f"no seeded evaluation image with decision margins (slot {slot})")


def eval_batches(images: Sequence[np.ndarray], seed: int = 0) -> List[Dict[str, Any]]:
    """One evaluation batch dict per normalised image array [B, 512, 512, 1],
    built with numpy: gt boxes of up to a third of the image, gt-present
    (90%) and abnormal (30%) flags, reference phrases of WORDS for ~60% of
    the regions, and the reports they join into."""
    rng = np.random.default_rng(seed)
    batches = []
    for image in images:
        b = image.shape[0]
        has_sent = rng.uniform(size=(b, 29)) < 0.6
        phrases = [[" ".join(rng.choice(WORDS[:-1], rng.integers(2, 7))).capitalize() + "."
                    if has_sent[i, r] else "" for r in range(29)] for i in range(b)]
        boxes = []
        for _ in range(b):
            x1, y1 = rng.uniform(0, 511, 29), rng.uniform(0, 511, 29)
            w, h = rng.uniform(1, 512 / 3, 29), rng.uniform(1, 512 / 3, 29)
            boxes.append(np.stack([x1, y1, np.minimum(x1 + w, 512), np.minimum(y1 + h, 512)],
                                  axis=1).astype(np.float32))
        batches.append({
            "images": image,
            "gt_boxes": np.stack(boxes),
            "gt_labels": np.tile(np.arange(1, 30, dtype=np.int32), (b, 1)),
            "gt_valid": rng.uniform(size=(b, 29)) < 0.9,
            "region_has_sentence": has_sent,
            "region_is_abnormal": rng.uniform(size=(b, 29)) < 0.3,
            "reference_phrases": phrases,
            "reference_reports": [" ".join(p for p in row if p) for row in phrases],
        })
    return batches

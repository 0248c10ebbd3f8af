"""Evaluation entry points (the port's own copy): validation / test-set
evaluation and bbox-variation robustness, mirroring the reference's
harnesses:

  - detector metrics (evaluate_model.py:216-283): per-region micro-IoU
    (summed intersection / summed union of the top-1 box vs gt, over
    detected and gt-present pairs), per-region detection frequency,
    average detected regions per image;
  - binary-classifier P/R/F1 on detected regions (selection vs
    region_has_sentence; abnormal vs region_is_abnormal);
  - language metrics: generated region sentences -> NLG scores (sentence
    and report level) and CheXbert CE scores; decode output is already
    [B, 29, L], so each sentence keeps its region;
  - validation losses (`validation_losses`): the training losses per
    module under eval semantics, with a fixed sampling generator;
  - bbox-variation robustness (evaluate_bbox_variations.py): perturb gt
    boxes by position/scale/aspect-ratio noise of increasing std, RoI-pool
    features directly from the perturbed boxes (RPN bypassed), decode, and
    track sentence METEOR vs std.

Batches are the numpy dicts of data/dataset.py; the images go to the
device the parameters live on, where the detector runs K1 (NMS) and K2
(RoIAlign) and beam search K3 (beam attention); on CPU tensors each runs
its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.eval import nlg
from rgrg_tpu_torch.models.full_model import RGRG, Params
from rgrg_tpu_torch.text.report import assemble_report
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
from rgrg_tpu_torch.train.trainer import batch_to_device, compute_losses


# ---------------------------------------------------------------------------
# detector + classifier metric accumulators
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DetectorMetrics:
    intersection: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(C.NUM_REGIONS))
    union: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(C.NUM_REGIONS))
    detected: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(C.NUM_REGIONS))
    gt_present: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(C.NUM_REGIONS))
    images: int = 0

    def update(self, pred_boxes: np.ndarray, class_detected: np.ndarray,
               gt_boxes: np.ndarray, gt_valid: np.ndarray) -> None:
        """All arrays batched: [B, 29, 4] / [B, 29] ..."""
        both = class_detected & gt_valid
        x1 = np.maximum(pred_boxes[..., 0], gt_boxes[..., 0])
        y1 = np.maximum(pred_boxes[..., 1], gt_boxes[..., 1])
        x2 = np.minimum(pred_boxes[..., 2], gt_boxes[..., 2])
        y2 = np.minimum(pred_boxes[..., 3], gt_boxes[..., 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        area_p = ((pred_boxes[..., 2] - pred_boxes[..., 0])
                  * (pred_boxes[..., 3] - pred_boxes[..., 1]))
        area_g = ((gt_boxes[..., 2] - gt_boxes[..., 0])
                  * (gt_boxes[..., 3] - gt_boxes[..., 1]))
        union = area_p + area_g - inter
        self.intersection += np.where(both, inter, 0.0).sum(axis=0)
        self.union += np.where(both, union, 0.0).sum(axis=0)
        self.detected += class_detected.sum(axis=0)
        self.gt_present += gt_valid.sum(axis=0)
        self.images += pred_boxes.shape[0]

    def compute(self) -> Dict[str, Any]:
        iou = np.divide(self.intersection, self.union,
                        out=np.zeros_like(self.intersection),
                        where=self.union > 0)
        freq = self.detected / max(self.images, 1)
        return {
            "avg_detections_per_image": float(self.detected.sum()) / max(self.images, 1),
            "avg_iou": float(iou.mean()),
            "per_region_iou": {C.REGION_NAMES[i]: float(iou[i])
                               for i in range(C.NUM_REGIONS)},
            "per_region_detection_freq": {C.REGION_NAMES[i]: float(freq[i])
                                          for i in range(C.NUM_REGIONS)},
        }


@dataclasses.dataclass
class BinaryMetrics:
    """P/R/F1 of the positive class (evaluate_model.py:344-357).

    `mask` restricts WHICH (image, region) cells enter the metric: both
    prediction and target are boolean-indexed by it, like the reference's
    subset indexing (evaluate_model.py:197-213 for the normal/abnormal
    selection subsets; :171-186 class_detected gating for the abnormal
    classifier). Prediction-side gating (selected_regions[~class_detected]
    = False) is already in `pred`, as in the reference: an undetected
    region with a gt sentence is a FN of the selection metrics, not a
    dropped cell."""
    tp: int = 0
    fp: int = 0
    fn: int = 0

    def update(self, pred: np.ndarray, target: np.ndarray,
               mask: np.ndarray) -> None:
        p = pred & mask
        t = target & mask
        self.tp += int((p & t).sum())
        self.fp += int((p & ~t).sum())
        self.fn += int((~p & t).sum())

    def compute(self) -> Dict[str, float]:
        prec = self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0
        rec = self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return {"precision": prec, "recall": rec, "f1": f1}


# ---------------------------------------------------------------------------
# language metrics collection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SentenceCollector:
    """Pairs generated and reference sentences at (image, region)
    granularity, with the region-abnormality split the reference tracks."""
    gen_sents: List[str] = dataclasses.field(default_factory=list)
    ref_sents: List[str] = dataclasses.field(default_factory=list)
    is_abnormal: List[bool] = dataclasses.field(default_factory=list)
    region_ids: List[int] = dataclasses.field(default_factory=list)
    image_ids: List[int] = dataclasses.field(default_factory=list)
    gen_reports: List[str] = dataclasses.field(default_factory=list)
    ref_reports: List[str] = dataclasses.field(default_factory=list)
    # per-report artifact payloads (evaluate_language_model.py:511-578):
    # [(region name, generated sentence), ...] and the soft-dedup removal map
    report_region_sents: List[List] = dataclasses.field(default_factory=list)
    report_removed: List[Dict[str, List[str]]] = dataclasses.field(
        default_factory=list)
    _next_image_id: int = 0

    def add_batch(self, output_ids: np.ndarray, decoded_mask: np.ndarray,
                  tokenizer: GPT2Tokenizer,
                  reference_phrases: Sequence[Sequence[str]],
                  region_is_abnormal: Optional[np.ndarray] = None,
                  reference_reports: Optional[Sequence[str]] = None,
                  similarity_fn=None, threshold: float = 0.9) -> None:
        b = output_ids.shape[0]
        for i in range(b):
            ordered = []
            region_sents = []
            image_id = self._next_image_id
            self._next_image_id += 1
            for r in range(C.NUM_REGIONS):
                if decoded_mask[i, r]:
                    text = tokenizer.decode(output_ids[i, r],
                                            skip_special_tokens=True)
                    ordered.append(text)
                    region_sents.append((C.REGION_NAMES[r], text))
                    ref = reference_phrases[i][r]
                    if ref:  # only score regions with a gt sentence
                        self.gen_sents.append(text)
                        self.ref_sents.append(ref)
                        self.region_ids.append(r)
                        self.image_ids.append(image_id)
                        if region_is_abnormal is not None:
                            self.is_abnormal.append(bool(region_is_abnormal[i, r]))
            # an empty csv cell is NaN, which is truthy: as in the JAX
            # package, its report is assembled and scored against NaN
            if reference_reports is not None and reference_reports[i]:
                report, removed = assemble_report(ordered, similarity_fn,
                                                  threshold,
                                                  return_removed=True)
                self.gen_reports.append(report)
                self.ref_reports.append(reference_reports[i])
                self.report_region_sents.append(region_sents)
                self.report_removed.append(removed)

    def compute(self, metrics=("bleu", "meteor", "rouge", "cider"),
                cider_df=None, cider_log_n=None) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.gen_sents:
            meteor = nlg.Meteor()
            cands = [nlg.pycoco_tokenize(t) for t in self.gen_sents]
            refs = [[nlg.pycoco_tokenize(t)] for t in self.ref_sents]
            pair_scores = [meteor.score_pair(c, r[0]) for c, r in zip(cands, refs)]
            out["sentence"] = {"meteor": float(np.mean(pair_scores))}
            if self.is_abnormal:
                ab = np.asarray(self.is_abnormal)
                ps = np.asarray(pair_scores)
                if ab.any():
                    out["sentence"]["meteor_abnormal"] = float(ps[ab].mean())
                if (~ab).any():
                    out["sentence"]["meteor_normal"] = float(ps[~ab].mean())
            per_region: Dict[str, float] = {}
            rid = np.asarray(self.region_ids)
            ps = np.asarray(pair_scores)
            for r in range(C.NUM_REGIONS):
                m = rid == r
                if m.any():
                    per_region[C.REGION_NAMES[r]] = float(ps[m].mean())
            out["sentence"]["per_region_meteor"] = per_region

            # meteor_ratio: matched-pair METEOR / mismatched-pair METEOR
            # within the same image (evaluate_language_model.py:352-396),
            # how region-specific the generated sentences are
            mismatch_scores = []
            iid = np.asarray(self.image_ids)
            for img in np.unique(iid):
                idx = np.nonzero(iid == img)[0]
                for a in idx:
                    for bb in idx:
                        if a != bb:
                            mismatch_scores.append(
                                meteor.score_pair(cands[a], refs[bb][0]))
            if mismatch_scores and np.mean(mismatch_scores) > 0:
                out["sentence"]["meteor_ratio"] = (
                    float(np.mean(pair_scores)) / float(np.mean(mismatch_scores)))
        if self.gen_reports:
            out["report"] = nlg.compute_nlg_scores(
                metrics, self.gen_reports, self.ref_reports,
                cider_df=cider_df, cider_log_n=cider_log_n)
        return out


# ---------------------------------------------------------------------------
# evaluation passes
# ---------------------------------------------------------------------------

def _device_of(params: Params) -> torch.device:
    return next(params["detector"].parameters()).device


def evaluate_model(model: RGRG, params: Params,
                   batches: Iterable[Dict[str, Any]],
                   tokenizer: Optional[GPT2Tokenizer] = None,
                   generate_language: bool = True,
                   num_beams: int = 1, max_length: int = 64,
                   early_stopping: bool = True,
                   kv_cache_dtype: Optional[torch.dtype] = None,
                   max_language_batches: int = 100,
                   similarity_fn="auto",
                   chexbert: Optional[Callable[[List[str]], np.ndarray]] = None,
                   artifacts_dir: Optional[str] = None, step: int = 0,
                   num_figure_images: int = 0,
                   cider_df=None, cider_log_n=None,
                   cascade_stats="auto",
                   ) -> Dict[str, Any]:
    """Full validation pass: detector + classifier metrics over all batches;
    language generation/metrics over <= max_language_batches (the reference
    caps at 100, evaluate_language_model.py:1184-1206). The batches' images
    run on the device of `params`.

    early_stopping defaults True so the beam call is argument-identical to
    the reference's generate(num_beams=4, early_stopping=True); it is
    ignored for greedy. kv_cache_dtype: None = parameter-dtype KV cache;
    serving may use torch.int8.

    similarity_fn: "auto" takes eval/bertscore.default_scorer on the
    parameters' device (soft dedup when $RGRG_DISTILBERT_DIR names a
    distilbert; exact dedup otherwise), or a SimilarityFn, or None.
    chexbert: optional callable reports -> [14, N] labels for CE scores.
    artifacts_dir: when set, writes the reference's txt artifacts, generated
    sentence/report dumps (evaluate_language_model.py:511-578) and, with
    num_figure_images > 0, region-group bbox figures for the first batch's
    images (needs matplotlib).
    cascade_stats: serving.CascadeStats collecting per-rung closure
    telemetry and the bail-out policy ("auto" = create one; None = off).
    When observed rung-1 closure drops below the break-even threshold the
    remaining batches decode at max_length directly; the snapshot and the
    decode timing land in the returned scores under "language_generation".
    """
    dev = _device_of(params)
    if similarity_fn == "auto":
        # the reference's distilbert BERTScore soft dedup for report
        # assembly (evaluate_language_model.py:1048-1057); None when no
        # local weights: exact dedup only
        from rgrg_tpu_torch.eval.bertscore import default_scorer
        similarity_fn = default_scorer(device=dev)
    if cascade_stats == "auto":
        from rgrg_tpu_torch.serving import CascadeStats
        cascade_stats = CascadeStats()
    decode_seconds = 0.0
    language_images = 0
    t_loop = time.perf_counter()
    det_metrics = DetectorMetrics()
    # selection P/R/F1 over all / normal / abnormal regions (the reference's
    # region_selection_scores subsets, evaluate_model.py:332-357)
    sel_metrics = {s: BinaryMetrics() for s in ("all", "normal", "abnormal")}
    abn_metrics = BinaryMetrics()
    collector = SentenceCollector()

    for bi, batch in enumerate(batches):
        det = model.detect(params, torch.from_numpy(np.asarray(batch["images"])).to(dev))
        class_detected = det["class_detected"].cpu().numpy()
        top_boxes = det["top_region_boxes"].cpu().numpy()
        det_metrics.update(top_boxes, class_detected, batch["gt_boxes"], batch["gt_valid"])
        if bi == 0 and artifacts_dir and num_figure_images > 0:
            from rgrg_tpu_torch.eval.artifacts import save_figures
            save_figures(np.asarray(batch["images"]), batch.get("gt_boxes"), top_boxes,
                         artifacts_dir, step=step, max_images=num_figure_images)
        if "region_has_sentence" in batch:
            # detection gating is already in the PREDICTION (selected =
            # logits > thr & class_detected); the subsets index both sides
            # by region_is_abnormal only (evaluate_model.py:197-213)
            selected = det["selected_regions"].cpu().numpy()
            has_sent = batch["region_has_sentence"].astype(bool)
            abnormal = batch["region_is_abnormal"].astype(bool)
            sel_metrics["all"].update(selected, has_sent, np.ones_like(abnormal))
            sel_metrics["normal"].update(selected, has_sent, ~abnormal)
            sel_metrics["abnormal"].update(selected, has_sent, abnormal)
            # abnormal classifier: restricted to detected regions on both
            # sides (evaluate_model.py:171-186)
            abn_metrics.update(det["predicted_abnormal"].cpu().numpy(), abnormal,
                               class_detected)

        if (generate_language and tokenizer is not None
                and bi < max_language_batches and "reference_phrases" in batch):
            if cascade_stats is not None and cascade_stats.should_bail():
                # rung-1 closure is below break-even: the ladder's first
                # rung is overhead for this checkpoint's lengths, so the
                # remaining batches decode at max_length directly (a single
                # (max_length,) bucket gives the same outputs)
                cascade_stats.bailed_out = True
            bailed = cascade_stats is not None and cascade_stats.bailed_out
            t_dec = time.perf_counter()
            # the length-bucket cascade: outputs equal the full-length
            # decode (full_model.decode_selected_cascade says why)
            ids, decoded = model.decode_selected_cascade(
                params, det["region_features"], det["selected_regions"], max_length,
                num_beams=num_beams, early_stopping=early_stopping,
                kv_cache_dtype=kv_cache_dtype,
                buckets=(max_length,) if bailed else None,
                stats=None if bailed else cascade_stats)
            ids, decoded = ids.cpu().numpy(), decoded.cpu().numpy()
            decode_seconds += time.perf_counter() - t_dec
            language_images += int(np.asarray(batch["images"]).shape[0])
            collector.add_batch(ids, decoded, tokenizer, batch["reference_phrases"],
                                batch.get("region_is_abnormal"),
                                batch.get("reference_reports"),
                                similarity_fn=similarity_fn)

    loop_seconds = time.perf_counter() - t_loop
    out: Dict[str, Any] = {
        "language_generation": {
            "decode_seconds": round(decode_seconds, 3),
            "loop_seconds": round(loop_seconds, 3),
            "language_images": language_images,
            "reports_per_sec_decode": (round(language_images / decode_seconds, 3)
                                       if decode_seconds else None),
            "cascade": (cascade_stats.snapshot()
                        if cascade_stats is not None else None),
        },
        "object_detector": det_metrics.compute(),
        "region_selection": {s: m.compute() for s, m in sel_metrics.items()},
        "region_abnormal": abn_metrics.compute(),
    }
    out.update(collector.compute(cider_df=cider_df, cider_log_n=cider_log_n))
    if chexbert is not None and collector.gen_reports:
        from rgrg_tpu_torch.eval.chexbert import compute_ce_scores
        gen_labels = chexbert(collector.gen_reports)
        ref_labels = chexbert(collector.ref_reports)
        out.setdefault("report", {})["CE"] = compute_ce_scores(gen_labels, ref_labels)
    if artifacts_dir:
        from rgrg_tpu_torch.eval.artifacts import write_reports_txt, write_sentences_txt
        if collector.gen_sents:
            write_sentences_txt(collector, artifacts_dir, step)
        if collector.gen_reports:
            write_reports_txt(collector, artifacts_dir, step)
    return out


def validation_losses(model: RGRG, params: Params, batches: Iterable[Dict[str, Any]],
                      stage: int, tcfg, lm_budget: int = 128, max_batches: int = 20,
                      rng: Optional[Callable[[], Any]] = None) -> Dict[str, float]:
    """Per-module validation losses averaged over up to `max_batches`
    batches ("total" and each loss), computed as train.trainer.compute_losses
    does with train=False: BatchNorm running statistics, no dropout, the test
    RPN top-n. Every batch samples its proposals from the same draws: a
    generator seeded 0 on the params' device, or `rng()` (a fresh sampling
    source per batch), so the same batch always gives the same losses."""
    dev = _device_of(params)
    sums: Dict[str, float] = {}
    n = 0
    for bi, batch in enumerate(batches):
        if bi >= max_batches:
            break
        source = (torch.Generator(device=dev).manual_seed(0) if rng is None else rng())
        with torch.no_grad():
            total, losses = compute_losses(model, params, batch_to_device(batch, dev),
                                           source, stage, tcfg, lm_budget, train=False)
        sums["total"] = sums.get("total", 0.0) + float(total)
        for k, v in losses.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / n for k, v in sums.items()} if n else {"total": 0.0}


# ---------------------------------------------------------------------------
# bbox variation robustness (evaluate_bbox_variations.py)
# ---------------------------------------------------------------------------

def perturb_boxes(boxes: np.ndarray, rng: np.random.Generator, mode: str,
                  std: float, image_size: int = C.IMAGE_SIZE) -> np.ndarray:
    """Perturb [.., 4] xyxy boxes: 'position' shifts the center by
    N(0, std*dim); 'scale' rescales w/h by exp(N(0, std)); 'aspect' scales
    w by exp(N) and h by exp(-N) keeping the area
    (evaluate_bbox_variations.py:219-357 semantics)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + w / 2
    cy = boxes[..., 1] + h / 2
    if mode == "position":
        cx = cx + rng.normal(0, std, cx.shape) * w
        cy = cy + rng.normal(0, std, cy.shape) * h
    elif mode == "scale":
        f = np.exp(rng.normal(0, std, w.shape))
        w, h = w * f, h * f
    elif mode == "aspect":
        f = np.exp(rng.normal(0, std, w.shape))
        w, h = w * f, h / f
    else:
        raise ValueError(mode)
    out = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)
    out = np.clip(out, 0, image_size)
    # keep degenerate boxes minimally valid
    out[..., 2] = np.maximum(out[..., 2], out[..., 0] + 1e-2)
    out[..., 3] = np.maximum(out[..., 3], out[..., 1] + 1e-2)
    return out.astype(np.float32)


@torch.inference_mode()
def evaluate_bbox_variations(model: RGRG, params: Params,
                             batches: Iterable[Dict[str, Any]],
                             tokenizer: GPT2Tokenizer, mode: str,
                             stds: Sequence[float] = tuple(np.arange(0, 2.0, 0.1)),
                             max_length: int = 64, num_beams: int = 1,
                             seed: int = 0) -> Dict[float, float]:
    """For each noise std: perturb gt boxes, RoI-pool features directly from
    them (RPN bypassed), decode, score sentence METEOR. Returns
    {std: meteor}."""
    cached = [b for b in batches]
    meteor = nlg.Meteor()
    results: Dict[float, float] = {}
    det = params["detector"]
    dev = _device_of(params)

    for std in stds:
        rng = np.random.default_rng(seed)
        scores = []
        for batch in cached:
            boxes = perturb_boxes(batch["gt_boxes"], rng, mode, float(std))
            feats = det.backbone(torch.from_numpy(np.asarray(batch["images"])).to(dev))
            region_feats = det.region_features_from_boxes(feats, torch.from_numpy(boxes).to(dev))
            valid = batch["gt_valid"] & batch["region_has_sentence"].astype(bool)
            ids, decoded = model.decode_selected(
                params, region_feats, torch.from_numpy(valid).to(dev),
                model.budget_for(int(valid.sum()), boxes.shape[0]),
                max_length, num_beams=num_beams)
            ids, decoded = ids.cpu().numpy(), decoded.cpu().numpy()
            for i in range(boxes.shape[0]):
                for r in range(C.NUM_REGIONS):
                    if decoded[i, r] and batch["reference_phrases"][i][r]:
                        gen = tokenizer.decode(ids[i, r], skip_special_tokens=True)
                        scores.append(meteor.score_pair(
                            nlg.pycoco_tokenize(gen),
                            nlg.pycoco_tokenize(batch["reference_phrases"][i][r])))
        results[float(std)] = float(np.mean(scores)) if scores else 0.0
    return results

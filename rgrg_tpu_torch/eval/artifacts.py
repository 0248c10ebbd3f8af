"""Evaluation artifacts: generated sentence/report txt dumps, the
final_scores.txt summary, and bbox/sentence figures (the port's own copy;
only the figures need matplotlib, imported when they are drawn).

Reference formats mirrored exactly:
  - sentence/report txts: evaluate_language_model.py:511-578
    ("Generated sentence:"/"Reference sentence:" pairs; report blocks with
    region sentences and the soft-dedup removal map),
  - final_scores.txt: test_set_evaluation.py:77-177 (flat "key: value"
    lines — detector, selection/abnormal classifiers, CE, NLG),
  - figures: training_script_object_detector.py:93-147 region-group bbox
    plots (rendered by utils.plots, saved as PNGs here).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np


def _region_key(name: str) -> str:
    return "_".join(name.split())


def write_sentences_txt(collector, out_dir: str, step: int = 0) -> None:
    """generated_sentences_step_N + generated_abnormal_sentences_step_N."""
    sent_dir = os.path.join(out_dir, "generated_sentences")
    os.makedirs(sent_dir, exist_ok=True)
    # abnormality flags are only trustworthy when EVERY batch supplied them:
    # a partially-populated list would zip positionally against gen_sents and
    # attribute later sentences' flags to earlier ones
    ab = (collector.is_abnormal
          if len(collector.is_abnormal) == len(collector.gen_sents)
          else [False] * len(collector.gen_sents))

    with open(os.path.join(sent_dir,
                           f"generated_sentences_step_{step}.txt"), "w") as f:
        for gen, ref in zip(collector.gen_sents, collector.ref_sents):
            f.write(f"Generated sentence: {gen}\n")
            f.write(f"Reference sentence: {ref}\n\n")

    with open(os.path.join(
            sent_dir, f"generated_abnormal_sentences_step_{step}.txt"), "w") as f:
        for gen, ref, a in zip(collector.gen_sents, collector.ref_sents, ab):
            if a:
                f.write(f"Generated sentence: {gen}\n")
                f.write(f"Reference sentence: {ref}\n\n")


def write_reports_txt(collector, out_dir: str, step: int = 0) -> None:
    """generated_reports_step_N with region sentences + dedup removals."""
    rep_dir = os.path.join(out_dir, "generated_reports")
    os.makedirs(rep_dir, exist_ok=True)
    n = len(collector.gen_reports)
    region_sents = (collector.report_region_sents
                    if len(collector.report_region_sents) == n else [[]] * n)
    removed = (collector.report_removed
               if len(collector.report_removed) == n else [{}] * n)

    with open(os.path.join(rep_dir,
                           f"generated_reports_step_{step}.txt"), "w") as f:
        for gen, ref, regions, rem in zip(collector.gen_reports,
                                          collector.ref_reports,
                                          region_sents, removed):
            f.write(f"Generated report: {gen}\n\n")
            f.write(f"Reference report: {ref}\n\n")
            f.write("Generated sentences with their regions:\n")
            for region_name, sent in regions:
                f.write(f"\t{region_name}: {sent}\n")
            f.write("\n")
            f.write("Generated sentences that were removed:\n")
            for sent, similar in rem.items():
                f.write(f"\t{sent} == {similar}\n")
            f.write("\n")
            f.write("=" * 30)
            f.write("\n\n")


def write_final_scores(scores: Mapping[str, Any], path: str) -> None:
    """Flat "key: value" lines in the reference's final_scores.txt order."""
    lines = []

    det = scores.get("object_detector", {})
    if det:
        lines.append(("avg_num_detected_regions_per_image",
                      det["avg_detections_per_image"]))
        lines.append(("avg_iou", det["avg_iou"]))
        for name, v in det.get("per_region_detection_freq", {}).items():
            lines.append((f"num_detected_{_region_key(name)}", v))
        for name, v in det.get("per_region_iou", {}).items():
            lines.append((f"iou_{_region_key(name)}", v))

    sel = scores.get("region_selection", {})
    if sel and not isinstance(next(iter(sel.values()), 0.0), Mapping):
        sel = {"all": sel}
    for subset, metrics in (sel or {}).items():
        for metric, v in metrics.items():
            lines.append((f"region_select_{subset}_{metric}", v))
    for metric, v in scores.get("region_abnormal", {}).items():
        lines.append((f"region_abnormal_{metric}", v))

    rep = scores.get("report", {})
    ce: Dict[str, Any] = {}
    for k, v in rep.get("CE", {}).items():
        # eval/chexbert.compute_ce_scores nests the conditions' blocks under
        # "per_condition"; each is written as its condition's lines (the
        # JAX package's writer raises on that nesting)
        ce.update(v if k == "per_condition" else {k: v})
    for k, v in ce.items():
        if isinstance(v, Mapping):  # per-condition block
            cname = _region_key(k.lower())
            for metric, s in v.items():
                lines.append((f"report_CE_{cname}_{metric}", s))
        else:
            lines.append((f"report_CE_{k}", v))
    for k, v in rep.items():
        if k != "CE":
            lines.append((f"report_{k}", v))
    for k, v in scores.get("sentence", {}).items():
        if isinstance(v, Mapping):  # per-region meteor
            for name, s in v.items():
                lines.append((f"sentence_meteor_{_region_key(name)}", s))
        else:
            lines.append((f"sentence_{k}", v))

    with open(path, "w") as f:
        for k, v in lines:
            f.write(f"{k}: {float(v):.5f}\n")


def save_figures(images: np.ndarray, gt_boxes: Optional[np.ndarray],
                 pred_boxes: np.ndarray, out_dir: str, step: int = 0,
                 max_images: int = 2,
                 sentences: Optional[Dict[str, str]] = None) -> None:
    """Region-group bbox figures for the first max_images, saved as PNGs
    (the reference logs the same figures to tensorboard)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from rgrg_tpu_torch.utils.plots import plot_region_groups

    fig_dir = os.path.join(out_dir, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    for i in range(min(max_images, images.shape[0])):
        figs = plot_region_groups(
            np.asarray(images[i]),
            None if gt_boxes is None else np.asarray(gt_boxes[i]),
            np.asarray(pred_boxes[i]), sentences)
        for group, arr in figs.items():
            plt.imsave(os.path.join(fig_dir, f"step{step}_img{i}_{group}.png"), arr)

"""Bbox / sentence figure plotting (the port's own copy; matplotlib is
imported inside the plotting function only).

Reference equivalents: gt/pred box figures in region groups
(training_script_object_detector.py:93-147) and generated-sentence image
plots (evaluate_language_model.py:581-860). Figures are rendered with
matplotlib to numpy RGB arrays; MetricWriter-compatible.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from rgrg_tpu_torch.core import constants as C

# the reference plots boxes in 5 thematic groups to keep figures readable
REGION_GROUPS: Dict[str, Sequence[str]] = {
    "lungs_right": ["right lung", "right upper lung zone", "right mid lung zone",
                    "right lower lung zone", "right hilar structures",
                    "right apical zone"],
    "lungs_left": ["left lung", "left upper lung zone", "left mid lung zone",
                   "left lower lung zone", "left hilar structures",
                   "left apical zone"],
    "diaphragm": ["right costophrenic angle", "right hemidiaphragm",
                  "left costophrenic angle", "left hemidiaphragm", "abdomen"],
    "mediastinum": ["mediastinum", "upper mediastinum", "cardiac silhouette",
                    "aortic arch", "svc", "cavoatrial junction", "right atrium"],
    "bones_other": ["spine", "trachea", "right clavicle", "left clavicle",
                    "carina"],
}


def plot_boxes(image: np.ndarray, gt_boxes: Optional[np.ndarray],
               pred_boxes: Optional[np.ndarray], region_names: Sequence[str],
               sentences: Optional[Dict[str, str]] = None,
               title: str = "") -> np.ndarray:
    """image: [H, W] or [H, W, 1] normalized/raw; boxes [29, 4] indexed by
    region id. Returns an RGB uint8 figure array."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    img = np.asarray(image)
    if img.ndim == 3:
        img = img[..., 0]
    fig, ax = plt.subplots(figsize=(7, 7), dpi=110)
    ax.imshow(img, cmap="gray")
    ax.set_title(title, fontsize=9)
    ax.axis("off")

    for name in region_names:
        r = C.ANATOMICAL_REGIONS[name]
        if gt_boxes is not None and np.any(gt_boxes[r] != 0):
            x1, y1, x2, y2 = gt_boxes[r]
            ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                                   edgecolor="lime", linewidth=1.2))
        if pred_boxes is not None and np.any(pred_boxes[r] != 0):
            x1, y1, x2, y2 = pred_boxes[r]
            ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                                   edgecolor="red", linewidth=1.0,
                                   linestyle="--"))
            if sentences and name in sentences:
                ax.text(x1, max(y1 - 3, 0), sentences[name][:60],
                        color="yellow", fontsize=5)

    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def plot_region_groups(image, gt_boxes, pred_boxes,
                       sentences=None) -> Dict[str, np.ndarray]:
    """One figure per reference region group."""
    return {group: plot_boxes(image, gt_boxes, pred_boxes, names, sentences,
                              title=group)
            for group, names in REGION_GROUPS.items()}

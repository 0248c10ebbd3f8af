"""Dataset statistics (the port's own copy of the JAX package's
`data/stats.py`).

Reference equivalents:
  - compute_mean_std_dataset.py: streaming pixel mean/std of the train split
    (result 0.471 / 0.302, hardcoded at every transform site);
  - compute_stats_dataset.py: counts that justify the classifier
    pos_weights (~2.2x regions w/o sentence, ~6x normal vs abnormal);
  - compute_cider_document_frequencies.py: CIDEr-D doc frequencies from the
    VALIDATION reference reports (wordpunct + lowercase), cached as a
    gzip'd pickle of {"df": {ngram tuple: count}, "log_num_docs": float},
    the counterpart of the reference's mimic-cxr-document-frequency.bin.gz.
    Only load files this tool (or the JAX package's) wrote: unpickling runs
    code.

`dataset_stats` counts over the row dicts of `data/dataset.read_split_csv`
(no pandas).
"""

from __future__ import annotations

import gzip
import pickle
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.eval import nlg

_WORDPUNCT = re.compile(r"\w+|[^\w\s]+")


def compute_mean_std(image_paths: Iterable[str],
                     tolerance: float = 1e-4,
                     patience: int = 10) -> Tuple[float, float]:
    """Streaming mean/std over normalized [0,1] pixels with convergence
    patience (reference compute_mean_std_dataset.py semantics: once the
    running values held still for `patience` images, the values of the
    image before the last one are returned)."""
    from rgrg_tpu_torch.data import transforms
    count = 0
    total = 0.0
    total_sq = 0.0
    last = (None, None)
    stable = 0
    for path in image_paths:
        img = transforms.load_image(path).astype(np.float64) / 255.0
        count += img.size
        total += img.sum()
        total_sq += (img * img).sum()
        mean = total / count
        std = np.sqrt(total_sq / count - mean * mean)
        if last[0] is not None and abs(mean - last[0]) < tolerance \
                and abs(std - last[1]) < tolerance:
            stable += 1
            if stable >= patience:
                break
        else:
            stable = 0
        last = (mean, std)
    return float(last[0] or 0.0), float(last[1] or 0.0)


def dataset_stats(rows: Sequence[Dict]) -> Dict[str, float]:
    """Counts over a split's rows (read_split_csv): images, bbox/phrase/
    abnormality ratios — the numbers behind pos_weight 2.2 / 6.0
    (dataset_stats.txt:5-9)."""
    num_images = len(rows)
    num_bboxes = sum(len(r["bbox_labels"]) for r in rows)
    num_with_phrase = sum(sum(r["bbox_phrase_exists"]) for r in rows)
    num_abnormal = sum(sum(r["bbox_is_abnormal"]) for r in rows)
    total_slots = num_images * C.NUM_REGIONS
    return {
        "num_images": num_images,
        "num_bboxes": num_bboxes,
        "num_regions_with_sentence": num_with_phrase,
        "num_abnormal_regions": num_abnormal,
        "frac_regions_with_sentence": num_with_phrase / max(total_slots, 1),
        "ratio_without_to_with_sentence":
            (total_slots - num_with_phrase) / max(num_with_phrase, 1),
        "ratio_normal_to_abnormal":
            (total_slots - num_abnormal) / max(num_abnormal, 1),
    }


def wordpunct_lower(text: str):
    """Miura-bugfixed tokenization for CIDEr document frequencies
    (compute_cider_document_frequencies.py:45-67)."""
    return [t.lower() for t in _WORDPUNCT.findall(text)]


def compute_cider_doc_frequencies(reference_reports: Iterable[str],
                                  save_path: Optional[str] = None):
    """df over validation reference reports; optionally cached gzip-pickled
    like the reference's mimic-cxr-document-frequency.bin.gz."""
    refs = [[wordpunct_lower(r)] for r in reference_reports]
    df, log_n = nlg.compute_doc_frequencies(refs)
    if save_path:
        with gzip.open(save_path, "wb") as f:
            pickle.dump({"df": df, "log_num_docs": log_n}, f)
    return df, log_n


def load_cider_doc_frequencies(path: str):
    with gzip.open(path, "rb") as f:
        obj = pickle.load(f)
    return obj["df"], obj["log_num_docs"]

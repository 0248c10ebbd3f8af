"""CSV-backed dataset + static-shape batch assembly (host side; the port's
own copy, without pandas).

Emits the fixed-shape batch dict the trainer and the evaluator consume:

  images            [B, S, S, 1] float32
  gt_boxes          [B, 29, 4]   (zero rows where absent)
  gt_labels         [B, 29]      (1..29; 0 where absent)
  gt_valid          [B, 29]      bool
  input_ids         [B, 29, L]   (pad-token rows where absent)
  attention_mask    [B, 29, L]
  region_has_sentence [B, 29]    bool
  region_is_abnormal  [B, 29]    bool
  reference_reports / reference_phrases: lists, where the split has them

Token rows are bucketed to a fixed `seq_len` (reference sentences are <60
tokens for ~95% of data; longer ones are truncated). Unreadable samples
are skipped like the reference's None-filtering collator. train=True
augments each sample (transforms.train_transform) with draws from the
dataset's numpy Generator, as the JAX package does.
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import logging
from itertools import islice
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.data import transforms as T
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

log = logging.getLogger(__name__)

CSV_USECOLS_TRAIN = ["mimic_image_file_path", "bbox_coordinates", "bbox_labels",
                     "bbox_phrases", "bbox_phrase_exists", "bbox_is_abnormal"]
_LITERAL_COLUMNS = ("bbox_coordinates", "bbox_labels", "bbox_phrases",
                    "bbox_phrase_exists", "bbox_is_abnormal")
# the cells pandas.read_csv reads as NaN by default
_NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
                        "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
                        "None", "n/a", "nan", "null"})

Row = Dict[str, Any]


def read_split_csv(path: str, usecols: Optional[Sequence[str]] = None,
                   nrows: Optional[int] = None) -> List[Row]:
    """Reads a split csv produced by the ETL (the reference's
    create_dataset.py schema) into one dict per row, parsing the
    python-literal list columns. Cells read as pandas.read_csv reads them
    for every column the evaluation path uses: text, or NaN (a float, so
    truthy) for an empty cell and pandas' other default NA spellings."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        keep = list(header) if usecols is None else list(usecols)
        missing = [c for c in keep if c not in header]
        if missing:
            raise ValueError(f"{path}: no column(s) {missing}")
        cols = [(c, header.index(c)) for c in header if c in keep]
        rows = []
        for cells in islice(reader, nrows):
            row = {c: (float("nan") if i >= len(cells) or cells[i] in _NA_VALUES
                       else cells[i]) for c, i in cols}
            for c in _LITERAL_COLUMNS:
                if c in row:
                    row[c] = ast.literal_eval(row[c])
            rows.append(row)
    return rows


@dataclasses.dataclass
class Sample:
    image: np.ndarray                 # [S, S, 1] float32
    gt_boxes: np.ndarray              # [29, 4]
    gt_labels: np.ndarray             # [29]
    gt_valid: np.ndarray              # [29] bool
    phrases: Optional[List[str]] = None      # 29 strings ("" = none)
    has_sentence: Optional[np.ndarray] = None
    is_abnormal: Optional[np.ndarray] = None
    reference_report: Optional[str] = None


def row_to_sample(row: Row, train: bool = False,
                  rng: Optional[np.random.Generator] = None,
                  tcfg: T.TransformConfig = T.TransformConfig()) -> Optional[Sample]:
    """One split row -> a Sample (train_transform with draws from `rng`
    when train, else val_transform), or None when its image cannot be
    read. A missing image decoder (no cv2) raises: it is a fault of the
    installation, not of the sample."""
    try:
        image = T.load_image(row["mimic_image_file_path"])
    except ImportError:
        raise
    except Exception as e:  # bad sample -> skip (reference returns None)
        log.warning("skipping unreadable image %s: %s",
                    row.get("mimic_image_file_path"), e)
        return None

    boxes = np.asarray(row["bbox_coordinates"], np.float32).reshape(-1, 4)
    labels = np.asarray(row["bbox_labels"], np.int32)
    if train:
        # boxes the warp pushed fully outside are dropped with their labels
        # (albumentations' bbox filtering): the region has no gt this step
        image, boxes, keep = T.train_transform(image, boxes, rng, tcfg)
        labels = labels[keep]
    else:
        image, boxes = T.val_transform(image, boxes, tcfg)

    # scatter into fixed 29-slot arrays by label (labels are 1..29, unique)
    gt_boxes = np.zeros((C.NUM_REGIONS, 4), np.float32)
    gt_labels = np.zeros((C.NUM_REGIONS,), np.int32)
    gt_valid = np.zeros((C.NUM_REGIONS,), bool)
    for b, lab in zip(boxes, labels):
        slot = int(lab) - 1
        gt_boxes[slot] = b
        gt_labels[slot] = lab
        gt_valid[slot] = True

    sample = Sample(image=image.astype(np.float32), gt_boxes=gt_boxes,
                    gt_labels=gt_labels, gt_valid=gt_valid)
    if "bbox_phrases" in row:
        sample.phrases = list(row["bbox_phrases"])
        sample.has_sentence = np.asarray(row["bbox_phrase_exists"], bool)
        sample.is_abnormal = np.asarray(row["bbox_is_abnormal"], bool)
    if "reference_report" in row:
        sample.reference_report = row["reference_report"]
    return sample


class RGRGDataset:
    """Indexable dataset over the rows of a split. train=True augments
    with draws from a numpy Generator seeded with `seed`."""

    def __init__(self, rows: Sequence[Row], tokenizer: Optional[GPT2Tokenizer],
                 train: bool = False, seq_len: int = 64, seed: int = 42,
                 tcfg: T.TransformConfig = T.TransformConfig()):
        self.rows = list(rows)
        self.tokenizer = tokenizer
        self.train = train
        self.seq_len = seq_len
        self.tcfg = tcfg
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Optional[Sample]:
        return row_to_sample(self.rows[idx], self.train,
                             self.rng if self.train else None, self.tcfg)

    def tokenize_phrases(self, phrases: List[str]):
        """'<|endoftext|>' + phrase + '<|endoftext|>' per region
        (train_full_model.py:389-395), padded/truncated to seq_len."""
        ids = np.full((C.NUM_REGIONS, self.seq_len),
                      self.tokenizer.pad_token_id, np.int32)
        mask = np.zeros((C.NUM_REGIONS, self.seq_len), np.float32)
        for r, phrase in enumerate(phrases):
            toks = self.tokenizer.encode(phrase, add_special=True)[:self.seq_len]
            ids[r, :len(toks)] = toks
            mask[r, :len(toks)] = 1.0
        return ids, mask

    def batches(self, batch_size: int, shuffle: bool = False, drop_last: bool = True,
                workers: int = 0) -> Iterator[Dict[str, Any]]:
        """Batches in row order, or in an order shuffled by the dataset's
        Generator. workers > 0 builds samples on a thread pool (the image
        decode and the numpy resize release the GIL in part), the analogue
        of the reference DataLoader's num_workers: each sample then draws
        its augmentations from a Generator seeded by SeedSequence([seed,
        epoch, index]), so the batches do not depend on thread scheduling
        (a different stream than workers=0's shared Generator, as in the
        JAX package)."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        samples = (self._parallel_samples(order, workers) if workers > 0
                   else (self[int(i)] for i in order))
        buf: List[Sample] = []
        for s in samples:
            if s is None:
                continue
            buf.append(s)
            if len(buf) == batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not drop_last:
            yield self._collate(buf)

    def _parallel_samples(self, order: np.ndarray, workers: int) -> Iterator[Optional[Sample]]:
        """Ordered sample construction with a bounded in-flight window
        (workers * 2), so an epoch never materializes ahead of the
        consumer. Each call is one epoch of the per-sample seeds."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        epoch = self._epoch
        self._epoch += 1

        def build(idx: int) -> Optional[Sample]:
            rng = (np.random.default_rng(np.random.SeedSequence([self.seed, epoch, idx]))
                   if self.train else None)
            return row_to_sample(self.rows[idx], self.train, rng, self.tcfg)

        with ThreadPoolExecutor(workers) as ex:
            it = iter(order.tolist())
            pending = deque(ex.submit(build, i) for i in islice(it, workers * 2))
            while pending:
                s = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(ex.submit(build, nxt))
                yield s

    def _collate(self, samples: List[Sample]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {
            "images": np.stack([s.image for s in samples]),
            "gt_boxes": np.stack([s.gt_boxes for s in samples]),
            "gt_labels": np.stack([s.gt_labels for s in samples]),
            "gt_valid": np.stack([s.gt_valid for s in samples]),
        }
        if samples[0].phrases is not None and self.tokenizer is not None:
            ids, mask = zip(*(self.tokenize_phrases(s.phrases) for s in samples))
            batch["input_ids"] = np.stack(ids)
            batch["attention_mask"] = np.stack(mask)
            batch["region_has_sentence"] = np.stack([s.has_sentence for s in samples])
            batch["region_is_abnormal"] = np.stack([s.is_abnormal for s in samples])
        if samples[0].reference_report is not None:
            batch["reference_reports"] = [s.reference_report for s in samples]
        if samples[0].phrases is not None:
            batch["reference_phrases"] = [s.phrases for s in samples]
        return batch

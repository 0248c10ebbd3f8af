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

`RGRGDataset.rank_batches` is the data-parallel form of `batches` on the
per-sample stream: each rank builds only its rows of every global batch,
and the ranks agree on where unreadable samples fell.
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import logging
from itertools import islice
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

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


@dataclasses.dataclass
class RankLoadStats:
    """What `RGRGDataset.rank_batches` cost a rank: the samples it built
    (readable or not; a build cancelled unstarted is not counted), the rows
    it yielded, its agreement rounds (calls of `exchange`) and the
    unreadable samples the ranks agreed on."""
    built: int = 0
    rows: int = 0
    rounds: int = 0
    unreadable: int = 0


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
        try:
            for s in samples:
                if s is None:
                    continue
                buf.append(s)
                if len(buf) == batch_size:
                    yield self._collate(buf)
                    buf = []
            if buf and not drop_last:
                yield self._collate(buf)
        finally:
            # a consumer that stops early: the builds in flight end before
            # close() returns, not whenever the collector frees the builder
            samples.close()

    def _parallel_samples(self, order: np.ndarray, workers: int) -> Iterator[Optional[Sample]]:
        """Ordered sample construction with a bounded in-flight window
        (workers * 2), so an epoch never materializes ahead of the
        consumer. Each call is one epoch of the per-sample seeds."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        epoch = self._epoch
        self._epoch += 1
        with ThreadPoolExecutor(workers) as ex:
            it = iter(order.tolist())
            pending = deque(ex.submit(self._seeded_sample, epoch, i)
                            for i in islice(it, workers * 2))
            while pending:
                s = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(ex.submit(self._seeded_sample, epoch, nxt))
                yield s

    def _seeded_sample(self, epoch: int, idx: int) -> Optional[Sample]:
        """Row `idx` in `epoch` of the per-sample stream: its augmentations
        drawn from SeedSequence([seed, epoch, idx]), whoever builds it."""
        rng = (np.random.default_rng(np.random.SeedSequence([self.seed, epoch, idx]))
               if self.train else None)
        return row_to_sample(self.rows[idx], self.train, rng, self.tcfg)

    def rank_batches(self, batch_size: int, rank: int, world: int,
                     exchange: Callable[[List[int]], Sequence[List[int]]],
                     shuffle: bool = False, workers: int = 1, ahead: int = 1,
                     stats: Optional[RankLoadStats] = None) -> Iterator[Dict[str, Any]]:
        """Rank `rank` of `world`'s share of batches(batch_size, shuffle,
        drop_last=True, workers > 0): of each global batch, rows [rank *
        per, (rank + 1) * per) with per = batch_size // world (the rows
        core.mesh.shard_pytree_batch keeps), bit for bit, built from the
        same per-sample seeds; list leaves, which shard_pytree_batch
        passes whole, hold the global batch's entries (read from the rows:
        they need no image). One epoch, like batches; every rank of the
        world must iterate it alike.

        A rank builds the samples at its rows' positions in the epoch's
        order, on `workers` threads, and those of the next `ahead`
        batches while the caller works on the current one. `exchange` is
        the ranks' agreement on unreadable samples: each rank calls it
        with the positions it found unreadable and gets every rank's
        list, in rank order (core.mesh.gather_objects on a host group).
        Once a batch, every rank learns which of the batch's positions
        could not be read; where one could not, the batch's rows move on
        past it, each rank builds the samples that moved into its rows,
        and the ranks agree again on the positions that are new to the
        batch. Every rank ends the epoch after the same number of
        batches. Calls `exchange` on the caller's thread: a producer
        thread per rank (data/prefetch.py) would stop after a different
        number of batches on each rank and leave the others waiting in
        it."""
        from concurrent.futures import ThreadPoolExecutor

        if batch_size % world:
            raise ValueError(f"a global batch of {batch_size} does not divide over "
                             f"{world} ranks")
        per = batch_size // world
        mine = slice(rank * per, (rank + 1) * per)
        stats = RankLoadStats() if stats is None else stats
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        order = order.tolist()
        epoch = self._epoch
        self._epoch += 1
        known: set = set()        # positions whose readability every rank knows
        unreadable: set = set()   # those of them that could not be read

        def window(start: int) -> Optional[List[int]]:
            """The positions of the global batch from `start`, those not
            known unreadable taken as readable; None past the epoch."""
            pos, p = [], start
            while len(pos) < batch_size:
                if p >= len(order):
                    return None
                if p not in unreadable:
                    pos.append(p)
                p += 1
            return pos

        futures: Dict[int, Any] = {}
        with ThreadPoolExecutor(workers) as ex:
            def build(positions: List[int]) -> None:
                for p in positions:
                    if p not in futures:
                        futures[p] = ex.submit(self._seeded_sample, epoch, order[p])
                        stats.built += 1

            try:
                start = 0
                while True:
                    pos = window(start)
                    while pos is not None:
                        build(pos[mine])
                        new = [p for p in pos if p not in known]
                        if not new:
                            break
                        failed = [p for p in pos[mine]
                                  if p not in known and futures[p].result() is None]
                        agreed = set().union(*exchange(failed))
                        stats.rounds += 1
                        known.update(new)
                        unreadable |= agreed
                        stats.unreadable += len(agreed)
                        if not agreed:
                            break
                        pos = window(start)
                    if pos is None:
                        return
                    samples = [futures.pop(p).result() for p in pos[mine]]
                    if any(s is None for s in samples):
                        raise RuntimeError(f"rank {rank}: a sample that another rank read "
                                           f"could not be read here")
                    start = pos[-1] + 1
                    for p in [p for p in futures if p < start]:
                        del futures[p]
                    nxt = start
                    for _ in range(ahead):
                        w = window(nxt)
                        if w is None:
                            break
                        build(w[mine])
                        nxt = w[-1] + 1
                    batch = self._collate(samples)
                    if "reference_reports" in batch:
                        batch["reference_reports"] = [self.rows[order[p]]["reference_report"]
                                                      for p in pos]
                    if "reference_phrases" in batch:
                        batch["reference_phrases"] = [list(self.rows[order[p]]["bbox_phrases"])
                                                      for p in pos]
                    stats.rows += per
                    yield batch
            finally:   # a consumer that stops early: builds not yet started are dropped
                stats.built -= sum(f.cancel() for f in futures.values())

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

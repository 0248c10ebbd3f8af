"""The comparison that decides `correct` for a training cell.

The program's step ran the first check steps of the run in set-up, and
one more mini-step, an update, after the window, from the state the
window left (`drivers/train_step.py`). The reference (`reference/train.py`,
float32, TF32 off) follows the check steps from the same weights, batches
and draws, and the judged step from the program's recorded state (its
trainable tensors, accumulated gradient and AdamW moments): it cannot
follow the window's steps from the start, so that one is followed from
where the program stood. It runs after the window, once the program's
state is freed. Compared, each as a gap relative to the reference:

- `loss_gap`: each check step's losses that come before the classifiers'
  detection decision or do not hinge on it (RPN objectness and deltas,
  RoI classes and deltas, the LM), each |program - reference| over
  |reference|, the largest over the terms and steps;
- `grad_gap`: the gradient the optimizer holds after the first step, per
  trainable tensor: |program's norm - reference's| over the larger of the
  reference's norm and the median tensor's, the largest over the tensors;
- `change_gap`: each trainable tensor's change once the optimizer has
  stepped (after the accumulation's last check step), measured alike, the
  median over the tensors;
- `steady_loss_gap`, `steady_change_gap`: the same two for the judged
  step after the window (its losses; each tensor's change by its update);
- `loader_mismatch`: the batches the program's loader built, checked by
  themselves against the corpus rows they name (each row found by its phrases): the
  token ids and mask of every region's phrase as the benchmark's
  vocabulary spells it, the sentence and abnormal flags, the labels of
  the boxes kept; an exact count of rows that differ.

The selection and abnormal losses are shown beside them in the total and
not compared: a region's detection can near-tie (the arg-max over classes
of one sampled proposal), and where rounding flips it the classifiers'
mask moves their losses (by 4e-4 and 9e-4 in steps 2 and 3 of one seed
of 40: the total by 1.8e-4, as much as the control moves it) and one
bias's change by 1.6e-3. The classifiers are held by the gradients and
the changes.

Tensors whose reference gradient is below a thousandth of the median
tensor's are left out of the gradient and change gaps (a bias ahead of a
softmax or a BatchNorm moves by round-off alone), by that rule and not
by name.

The control is the reference with TF32 products, the precision below the
configuration's float32 with TF32 off, put in the program's place.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.reference.train import TrainReference, seeded
from port_bench.reference.vocab import text_ids

FLOOR = 1e-3
COMPARED_LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
                   "loss_lm")


def on_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader batch's arrays as tensors on `device` (integers as int64)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            out[k] = (t if t.is_floating_point() or t.dtype == torch.bool
                      else t.long()).to(device)
    return out


class _TF32:
    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev
        return False


def follow(cfg: Dict, init: Dict[str, torch.Tensor], batches: List[Dict], steps: int,
           seed: int, tf32: bool) -> Dict:
    """The reference through `steps` mini-steps: losses, the first
    gradient's norms, each tensor's change norm after the last."""
    with _TF32(tf32):
        ref = TrainReference(cfg, init)
        device = ref.device
        losses = []
        for k in range(steps):
            losses.append(ref.step(on_device(batches[k], device), seeded(device, seed, k)))
            if k == 0:
                grads = ref.gradient_norms()
        with torch.no_grad():
            change = {n: float((ref.w[n] - init[n].float()).norm()) for n in ref.names}
    return {"losses": losses, "grads": grads, "change": change}


def follow_steady(cfg: Dict, init: Dict[str, torch.Tensor], steady: Dict, seed: int,
                  tf32: bool) -> Dict:
    """The reference through the judged step, from the program's recorded
    state: its losses and each tensor's change by the update."""
    snap = steady["state"]
    with _TF32(tf32):
        ref = TrainReference(cfg, {k: snap[k]["param"] if k in snap else v
                                   for k, v in init.items()})
        with torch.no_grad():
            for k in ref.names:
                ref.acc[k].copy_(snap[k]["acc"])
                ref.m[k].copy_(snap[k]["m"])
                ref.v[k].copy_(snap[k]["v"])
        ref.mini, ref.updates = steady["mini_step"], steady["updates"]
        device = ref.device
        losses = ref.step(on_device(steady["batch"], device), seeded(device, seed, steady["step"]))
        with torch.no_grad():
            change = {k: float((ref.w[k] - snap[k]["param"]).norm()) for k in ref.names}
    return {"losses": [losses], "change": change}


def gaps(side: Dict, ref: Dict, grads: Dict[str, float]) -> Dict[str, float]:
    """Loss and change gaps of one side against the reference; `grads`,
    the reference's first gradient, picks the tensors compared."""
    median = sorted(grads.values())[len(grads) // 2]
    kept = [n for n, v in grads.items() if v >= FLOOR * median]

    def leaf_gaps(key):
        vals = sorted(ref[key][n] for n in kept)
        med = vals[len(vals) // 2]
        return sorted(abs(side[key][n] - ref[key][n]) / max(ref[key][n], med) for n in kept)

    def worst(terms):
        return max(abs(p[t] - r[t]) / max(abs(r[t]), 1e-12)
                   for p, r in zip(side["losses"], ref["losses"]) for t in terms if t in r)

    change = leaf_gaps("change")
    out = {"loss_gap": worst(COMPARED_LOSSES), "change_gap": change[len(change) // 2],
           # shown and not compared (the module docstring says why)
           "total_loss_gap": worst(("loss_total",)), "change_gap_worst_tensor": change[-1],
           "tensors_compared": len(kept), "tensors_left_out": len(grads) - len(kept)}
    if "grads" in side:
        out["grad_gap"] = leaf_gaps("grads")[-1]
    return out


def loader_mismatch(cfg: Dict, batches: List[Dict], rows: List[Dict]) -> int:
    """Rows of the loader's batches that differ from the corpus row they
    name (see the module docstring)."""
    d, seq = cfg["decoder"], cfg["train"]["seq_len"]
    by_phrases = {tuple(r["bbox_phrases"]): r for r in rows}
    bad = 0
    for b in batches:
        for i, phrases in enumerate(b["reference_phrases"]):
            row = by_phrases.get(tuple(phrases))
            if row is None:
                bad += 1
                continue
            ids = np.full((len(phrases), seq), d["pad_token_id"], np.int64)
            mask = np.zeros((len(phrases), seq), np.float32)
            for k, text in enumerate(phrases):
                toks = ([d["bos_token_id"]] + text_ids(text) + [d["eos_token_id"]])[:seq]
                ids[k, :len(toks)], mask[k, :len(toks)] = toks, 1.0
            labels = np.zeros(len(phrases), np.int64)
            labels[np.asarray(row["bbox_labels"]) - 1] = row["bbox_labels"]
            valid = b["gt_valid"][i]
            bad += not (np.array_equal(b["input_ids"][i], ids)
                        and np.array_equal(b["attention_mask"][i], mask)
                        and np.array_equal(b["region_has_sentence"][i], row["bbox_phrase_exists"])
                        and np.array_equal(b["region_is_abnormal"][i], row["bbox_is_abnormal"])
                        and np.array_equal(b["gt_labels"][i], np.where(valid, labels, 0))
                        and not (valid & (labels == 0)).any())
    return bad


def judge(cfg: Dict, init: Dict[str, torch.Tensor], batches: List[Dict], record: Dict,
          seed: int, control: bool = False, steady: Optional[Dict] = None,
          rows: Optional[List[Dict]] = None,
          loaded: Optional[List[Dict]] = None) -> Dict[str, Dict[str, float]]:
    """{"program": numbers[, "control": numbers]}: the check steps, with
    `steady` the judged step after the window, and with `rows` the
    loader's batches (`loaded`) against the corpus rows."""
    steps = len(record["losses"])
    ref = follow(cfg, init, batches, steps, seed, tf32=False)
    sides = {"program": record}
    if control:
        sides["control"] = follow(cfg, init, batches, steps, seed, tf32=True)
    out = {k: gaps(v, ref, ref["grads"]) for k, v in sides.items()}
    if steady is not None:
        ref_s = follow_steady(cfg, init, steady, seed, tf32=False)
        steady_sides = {"program": steady}
        if control:
            steady_sides["control"] = follow_steady(cfg, init, steady, seed, tf32=True)
        for k, v in steady_sides.items():
            g = gaps(v, ref_s, ref["grads"])
            out[k].update(steady_loss_gap=g["loss_gap"], steady_change_gap=g["change_gap"],
                          steady_total_loss_gap=g["total_loss_gap"])
    if rows is not None:
        for k in out:
            out[k]["loader_mismatch"] = loader_mismatch(cfg, loaded, rows) if k == "program" else 0
    return out

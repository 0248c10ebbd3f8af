"""CheXbert labeler fine-tuning (the port's own copy of the JAX package's
eval/chexbert_train.py; the reference's vendored src/CheXbert/src/
run_bert.py): BERT and the 14 linear heads fine-tuned on labeled report
impressions with the mean of the per-head cross-entropies
(blank/positive/negative/uncertain; binary for "No Finding"), Adam at lr
2e-5.

torch.optim.Adam computes optax.adam's update, lr * m_hat / (sqrt(v_hat) +
eps) with eps 1e-8 and bias-corrected moments, in another order of float
operations (tests/test_torch_chexbert_train.py holds the two within 1e-6).
Parameters are the nested tensors of eval/chexbert.convert_chexbert and
are updated in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from rgrg_tpu_torch.eval.chexbert import CONDITIONS, BertConfig, chexbert_logits


def chexbert_loss(params: Dict[str, Any], input_ids: torch.Tensor,
                  attention_mask: torch.Tensor, labels: torch.Tensor,
                  cfg: BertConfig = BertConfig()) -> torch.Tensor:
    """labels [14, B] int (0..3; head 13 takes 0/1). The mean over the
    heads of each head's mean cross-entropy."""
    logits = chexbert_logits(params, input_ids, attention_mask, cfg)
    total = 0.0
    for i, lg in enumerate(logits):
        logp = torch.log_softmax(lg.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, 1, labels[i][:, None].long())[:, 0]
        total = total + nll.mean()
    return total / len(logits)


def parameters(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The leaf tensors of a nested parameter dict, in insertion order."""
    out: List[torch.Tensor] = []
    for v in params.values():
        out.extend(parameters(v) if isinstance(v, dict) else [v])
    return out


def make_train_step(params: Dict[str, Any], optimizer: torch.optim.Optimizer,
                    cfg: BertConfig = BertConfig()) -> Callable[..., torch.Tensor]:
    """step(input_ids, attention_mask, labels) -> loss: one forward,
    backward and optimizer step over `params` (which `optimizer` holds),
    in place. Inputs are tensors (or arrays) moved to the parameters'
    device."""
    dev = params["bert"]["word_embeddings"]["embedding"].device

    def step(input_ids, attention_mask, labels) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = chexbert_loss(params, torch.as_tensor(np.asarray(input_ids)).to(dev),
                             torch.as_tensor(np.asarray(attention_mask, np.float32)).to(dev),
                             torch.as_tensor(np.asarray(labels)).to(dev), cfg)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def train_chexbert(params: Dict[str, Any],
                   batches: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                   learning_rate: float = 2e-5, cfg: BertConfig = BertConfig()):
    """batches yield (input_ids [B, S], attention_mask [B, S], labels
    [14, B]). Trains `params` in place with Adam (the reference's lr 2e-5,
    run_bert.py LEARNING_RATE). Returns (params, losses)."""
    leaves = parameters(params)
    for t in leaves:
        t.requires_grad_(True)
    step = make_train_step(params, torch.optim.Adam(leaves, lr=learning_rate), cfg)
    losses = [float(step(ids, mask, labels)) for ids, mask, labels in batches]
    for t in leaves:
        t.requires_grad_(False)
    return params, losses


def labeler_metrics(preds: np.ndarray, labels: np.ndarray) -> Dict[str, Any]:
    """Per-condition accuracy and the mention / negation / uncertain /
    positive F1s the reference's utils.py reports. preds / labels [14, N]
    raw classes."""
    out: Dict[str, Any] = {"per_condition_acc": {
        cond: float((preds[i] == labels[i]).mean()) for i, cond in enumerate(CONDITIONS)}}

    def f1_of(p, l):
        tp = float(np.sum(p & l))
        fp = float(np.sum(p & ~l))
        fn = float(np.sum(~p & l))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        return 2 * prec * rec / (prec + rec) if prec + rec else 0.0

    out["mention_f1"] = f1_of(preds != 0, labels != 0)
    out["negation_f1"] = f1_of(preds == 2, labels == 2)
    out["uncertain_f1"] = f1_of(preds == 3, labels == 3)
    out["positive_f1"] = f1_of(preds == 1, labels == 1)
    return out

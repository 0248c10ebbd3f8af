"""CheXbert clinical-efficacy labeler (the port's own copy).

`bert_encode` is the standard post-LN BERT encoder with erf-GELU,
LayerNorm eps 1e-12 and an additive attention mask of -1e9, over the JAX
package's parameter layout (Dense kernels [in, out]) held as torch
tensors; the BERTScore soft-dedup scorer (eval/bertscore.py) shares it.
CheXbert puts 14 linear heads on the CLS row: 13 four-class
(blank/positive/negative/uncertain) and 1 two-class ("No Finding")
(the reference's bert_labeler.py:31-49). `convert_chexbert` reads the
published state dict ("module."-prefixed or bare); `compute_ce_scores`
gives the Miura micro and Nicolson example-based CE metrics
(evaluate_language_model.py:199-319).

Products run in float32 at PyTorch's default matmul precision ("highest":
no TF32 on the card), the counterpart of the JAX package's
`Precision.HIGHEST`; a caller that turns TF32 on for the process gets TF32
here too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from rgrg_tpu_torch.core.device import DeviceLike, resolve_device

CONDITIONS = ["Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity",
              "Lung Lesion", "Edema", "Consolidation", "Pneumonia",
              "Atelectasis", "Pneumothorax", "Pleural Effusion",
              "Pleural Other", "Fracture", "Support Devices", "No Finding"]

FIVE_CONDITIONS = {"Cardiomegaly", "Edema", "Consolidation", "Atelectasis",
                   "Pleural Effusion"}


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    eps: float = 1e-12


def _ln(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


def bert_encode(params: Dict[str, Any], input_ids: torch.Tensor,
                attention_mask: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """input_ids / attention_mask [B, S] -> hidden states [B, S, H] after
    cfg.layers layers."""
    b, s = input_ids.shape
    ids = input_ids.long()
    emb = (params["word_embeddings"]["embedding"][ids]
           + params["position_embeddings"]["embedding"][:s][None]
           + params["token_type_embeddings"]["embedding"][0])
    x = _ln(emb, params["emb_ln"], cfg.eps)

    bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * -1e9
    hd = cfg.hidden // cfg.heads

    def heads_split(t):
        return t.reshape(b, s, cfg.heads, hd).transpose(1, 2)

    for i in range(cfg.layers):
        lp = params[f"layer_{i}"]
        q = heads_split(_dense(x, lp["q"]))
        k = heads_split(_dense(x, lp["k"]))
        v = heads_split(_dense(x, lp["v"]))
        w = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        w = torch.softmax(w + bias, dim=-1)
        a = (w @ v).transpose(1, 2).reshape(b, s, cfg.hidden)
        x = _ln(x + _dense(a, lp["attn_out"]), lp["attn_ln"], cfg.eps)
        h = F.gelu(_dense(x, lp["intermediate"]), approximate="none")
        x = _ln(x + _dense(h, lp["output"]), lp["out_ln"], cfg.eps)
    return x


def chexbert_logits(params: Dict[str, Any], input_ids: torch.Tensor,
                    attention_mask: torch.Tensor,
                    cfg: BertConfig = BertConfig()) -> List[torch.Tensor]:
    """The 14 head logits over the CLS row: 13 x [B, 4] + 1 x [B, 2]."""
    hidden = bert_encode(params["bert"], input_ids, attention_mask, cfg)
    cls = hidden[:, 0, :]
    return [_dense(cls, params["heads"][i]) for i in range(14)]


@torch.inference_mode()
def chexbert_label(params: Dict[str, Any], input_ids, attention_mask,
                   cfg: BertConfig = BertConfig()) -> np.ndarray:
    """argmax labels [14, B] int32 (the reference label() layout). ids and mask
    (tensors or arrays) go to the device of the parameters."""
    dev = params["bert"]["word_embeddings"]["embedding"].device
    ids = torch.as_tensor(np.asarray(input_ids)).to(dev)
    mask = torch.as_tensor(np.asarray(attention_mask, np.float32)).to(dev)
    logits = chexbert_logits(params, ids, mask, cfg)
    return np.stack([lg.argmax(dim=-1).cpu().numpy() for lg in logits]).astype(np.int32)


# ---------------------------------------------------------------------------
# weight conversion
# ---------------------------------------------------------------------------

def convert_chexbert(sd: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """CheXbert state dict (torch tensors or numpy arrays) -> float32
    parameter tensors on `device` (default: the card), copies that share no
    memory with `sd` (fine-tuning updates them in place). Accepts
    DataParallel ("module."-prefixed) and bare checkpoints; bert under
    "bert.*", heads under "linear_heads.{i}.*"."""
    dev = resolve_device(device)
    sd = {(k[len("module."):] if k.startswith("module.") else k):
          torch.as_tensor(v).to(dev, torch.float32, copy=True) for k, v in sd.items()}

    def lin(key):
        return {"kernel": sd[f"{key}.weight"].t().contiguous(), "bias": sd[f"{key}.bias"]}

    def ln(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    e = "bert.embeddings"
    bert: Dict[str, Any] = {
        "word_embeddings": {"embedding": sd[f"{e}.word_embeddings.weight"]},
        "position_embeddings": {"embedding": sd[f"{e}.position_embeddings.weight"]},
        "token_type_embeddings": {"embedding": sd[f"{e}.token_type_embeddings.weight"]},
        "emb_ln": ln(f"{e}.LayerNorm"),
    }
    i = 0
    while f"bert.encoder.layer.{i}.attention.self.query.weight" in sd:
        p = f"bert.encoder.layer.{i}"
        bert[f"layer_{i}"] = {
            "q": lin(f"{p}.attention.self.query"),
            "k": lin(f"{p}.attention.self.key"),
            "v": lin(f"{p}.attention.self.value"),
            "attn_out": lin(f"{p}.attention.output.dense"),
            "attn_ln": ln(f"{p}.attention.output.LayerNorm"),
            "intermediate": lin(f"{p}.intermediate.dense"),
            "output": lin(f"{p}.output.dense"),
            "out_ln": ln(f"{p}.output.LayerNorm"),
        }
        i += 1
    heads = {j: lin(f"linear_heads.{j}") for j in range(14)}
    return {"bert": bert, "heads": heads}


# ---------------------------------------------------------------------------
# CE metrics (evaluate_language_model.py:199-319)
# ---------------------------------------------------------------------------

def _binary_prf_acc(ref: np.ndarray, gen: np.ndarray) -> Dict[str, float]:
    """sklearn average='binary' semantics with zero-division -> 0."""
    tp = int(np.sum((gen == 1) & (ref == 1)))
    fp = int(np.sum((gen == 1) & (ref == 0)))
    fn = int(np.sum((gen == 0) & (ref == 1)))
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    acc = float(np.mean(gen == ref)) if ref.size else 0.0
    return {"precision": p, "recall": r, "f1": f1, "acc": acc}


def miura_convert(labels: np.ndarray) -> np.ndarray:
    """2 -> 0 (negative class), 3 -> 1 (positive class)."""
    out = labels.copy()
    out[labels == 2] = 0
    out[labels == 3] = 1
    return out


def compute_ce_scores(preds_gen: np.ndarray, preds_ref: np.ndarray) -> Dict[str, Any]:
    """preds_*: [14, num_reports] raw CheXbert labels (0..3).

    Returns micro-averaged (Miura) scores over the 5 conditions and all 14,
    per-condition scores, and example-based (Nicolson) scores.
    """
    gen_m = miura_convert(preds_gen)
    ref_m = miura_convert(preds_ref)

    out: Dict[str, Any] = {"per_condition": {}}
    mask5 = np.array([c in FIVE_CONDITIONS for c in CONDITIONS])

    for ci, cond in enumerate(CONDITIONS):
        out["per_condition"][cond] = _binary_prf_acc(ref_m[ci], gen_m[ci])

    s14 = _binary_prf_acc(ref_m.ravel(), gen_m.ravel())
    s5 = _binary_prf_acc(ref_m[mask5].ravel(), gen_m[mask5].ravel())
    out.update({f"{k}_micro_all": v for k, v in s14.items()})
    out.update({f"{k}_micro_5": v for k, v in s5.items()})

    # example-based, Nicolson convention: only label 1 is positive
    g = preds_gen == 1
    r = preds_ref == 1
    tp = (g & r).sum(axis=0).astype(float)
    fp = (g & ~r).sum(axis=0).astype(float)
    fn = (~g & r).sum(axis=0).astype(float)
    tn = (~g & ~r).sum(axis=0).astype(float)
    with np.errstate(divide="ignore", invalid="ignore"):
        pe = np.nan_to_num(tp / (tp + fp))
        re = np.nan_to_num(tp / (tp + fn))
        fe = np.nan_to_num(2 * tp / (2 * tp + fp + fn))
        ae = np.nan_to_num((tp + tn) / (tp + tn + fp + fn))
    out["precision_example_all"] = float(pe.mean())
    out["recall_example_all"] = float(re.mean())
    out["f1_example_all"] = float(fe.mean())
    out["acc_example_all"] = float(ae.mean())
    return out

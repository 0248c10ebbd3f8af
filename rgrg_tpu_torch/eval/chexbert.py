"""BERT encoder of the CheXbert labeler (the port's own copy).

For now only what the BERTScore soft-dedup scorer (eval/bertscore.py)
needs: `BertConfig` and `bert_encode`, the standard post-LN BERT encoder
with erf-GELU, LayerNorm eps 1e-12 and an additive attention mask of -1e9,
over the JAX package's parameter layout (Dense kernels [in, out]) held as
torch tensors. The CheXbert heads, `chexbert_label` and the CE scores
belong to the evaluation slice and are not here yet.

Products run in float32 at PyTorch's default matmul precision ("highest":
no TF32 on the card), the counterpart of the JAX package's
`Precision.HIGHEST`; a caller that turns TF32 on for the process gets TF32
here too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F


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

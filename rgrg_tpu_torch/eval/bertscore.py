"""BERTScore soft-dedup scorer (distilbert-base-uncased; the port's own copy).

The reference removes near-duplicate generated sentences with HF
evaluate's bert_score: pairwise BERTScore-F1 with
model_type="distilbert-base-uncased" and threshold 0.9, removing the
SHORTER sentence of a similar pair (generate_reports_for_images.py:60-96).
The JAX package's default `ReportGenerator(similarity_fn="auto")` loads this
scorer from $RGRG_DISTILBERT_DIR; this module gives the port the same
default with the same semantics:

  * embeddings = hidden states after layer 5 of distilbert (bert_score's
    default layer for that model), L2-normalised;
  * greedy cosine matching: P = mean over candidate tokens of the best
    match in the reference, R = the other way round, F1 = 2PR/(P+R) (0
    where P+R == 0);
  * [CLS]/[SEP] weighted 0, padding excluded;
  * all unique sentences of a batch of pairs embedded in one encoder call,
    padded to the JAX package's length buckets, and every pair's F1 from
    one batched contraction.

distilbert is a 6-layer BERT without token-type embeddings; conversion
supplies a zero token-type row so eval/chexbert.bert_encode serves both.
The scorer runs on an explicit device (the ReportGenerator's).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from rgrg_tpu_torch.core.device import DeviceLike, resolve_device
from rgrg_tpu_torch.eval.chexbert import BertConfig, bert_encode
from rgrg_tpu_torch.text.wordpiece import WordPieceTokenizer

DISTILBERT_CONFIG = BertConfig(layers=6)
# bert_score embeds with the hidden states AFTER this many transformer
# layers (its per-model default table: distilbert-base-uncased -> 5)
BERTSCORE_LAYER = 5
BERTSCORE_SIMILARITY_THRESHOLD = 0.9


def convert_distilbert(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF DistilBertModel state_dict (CPU tensors) -> the encoder's
    parameter dict (Dense kernels [in, out]) of float32 tensors."""
    sd = {k[len("distilbert."):] if k.startswith("distilbert.") else k: v.float()
          for k, v in sd.items()}

    def lin(key):
        return {"kernel": sd[f"{key}.weight"].t().contiguous(),
                "bias": sd[f"{key}.bias"]}

    def ln(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    word = sd["embeddings.word_embeddings.weight"]
    params: Dict[str, Any] = {
        "word_embeddings": {"embedding": word},
        "position_embeddings": {"embedding": sd["embeddings.position_embeddings.weight"]},
        "token_type_embeddings": {"embedding": torch.zeros((1, word.shape[1]))},
        "emb_ln": ln("embeddings.LayerNorm"),
    }
    i = 0
    while f"transformer.layer.{i}.attention.q_lin.weight" in sd:
        p = f"transformer.layer.{i}"
        params[f"layer_{i}"] = {
            "q": lin(f"{p}.attention.q_lin"),
            "k": lin(f"{p}.attention.k_lin"),
            "v": lin(f"{p}.attention.v_lin"),
            "attn_out": lin(f"{p}.attention.out_lin"),
            "attn_ln": ln(f"{p}.sa_layer_norm"),
            "intermediate": lin(f"{p}.ffn.lin1"),
            "output": lin(f"{p}.ffn.lin2"),
            "out_ln": ln(f"{p}.output_layer_norm"),
        }
        i += 1
    return params


def _bucket(n: int, floor: int = 16, cap: int | None = None) -> int:
    b = floor
    while b < n:
        b *= 2
    return min(b, cap) if cap else b


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _embed(params, ids: torch.Tensor, mask: torch.Tensor, cfg: BertConfig,
           layer: int) -> torch.Tensor:
    hidden = bert_encode(params, ids, mask, dataclasses.replace(cfg, layers=layer))
    norm = torch.linalg.vector_norm(hidden, dim=-1, keepdim=True)
    return hidden / torch.clamp(norm, min=1e-12)


def _pair_f1(emb: torch.Tensor, weight: torch.Tensor, ia: torch.Tensor,
             ib: torch.Tensor) -> torch.Tensor:
    """emb [N,S,H] L2-normalised, weight [N,S] (1 = scored token), ia/ib
    [P] sentence indices -> F1 [P]."""
    a, b = emb[ia], emb[ib]            # [P,S,H]
    wa, wb = weight[ia], weight[ib]    # [P,S]
    sim = a @ b.transpose(1, 2)        # [P,S,S]
    neg = torch.tensor(-1e9, dtype=sim.dtype, device=sim.device)
    best_ab = torch.where(wb[:, None, :] > 0, sim, neg).amax(dim=2)  # [P,S]
    best_ba = torch.where(wa[:, :, None] > 0, sim, neg).amax(dim=1)  # [P,S]
    p = (best_ab * wa).sum(-1) / torch.clamp(wa.sum(-1), min=1e-9)
    r = (best_ba * wb).sum(-1) / torch.clamp(wb.sum(-1), min=1e-9)
    return torch.where(p + r > 0, 2 * p * r / torch.clamp(p + r, min=1e-12),
                       torch.zeros_like(p))


class BERTScorer:
    """Batched BERTScore-F1 over sentence pairs on one device; plugs into
    text.report.SimilarityFn."""

    def __init__(self, params: Dict[str, Any], tokenizer: WordPieceTokenizer,
                 cfg: BertConfig = DISTILBERT_CONFIG, layer: int = BERTSCORE_LAYER,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = _to(params, self.device)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.layer = layer

    @torch.inference_mode()
    def embed(self, sentences: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """One encoder call for all sentences: (emb [N,S,H], weight [N,S])
        with [CLS]/[SEP]/pad weighted 0; N padded to a power of two and S to
        a doubling of 16 (at most max_positions), as in the JAX package."""
        tok = self.tokenizer
        seqs = [tok.encode(s, max_len=self.cfg.max_positions) for s in sentences]
        s_pad = _bucket(max(len(q) for q in seqs), floor=16, cap=self.cfg.max_positions)
        n_pad = _bucket(len(seqs), floor=1)
        ids = np.full((n_pad, s_pad), tok.pad_id, np.int64)
        attn = np.zeros((n_pad, s_pad), np.float32)
        weight = np.zeros((n_pad, s_pad), np.float32)
        for i, q in enumerate(seqs):
            q = q[:s_pad]
            ids[i, :len(q)] = q
            attn[i, :len(q)] = 1.0
            weight[i, :len(q)] = [0.0 if t in (tok.cls_id, tok.sep_id) else 1.0 for t in q]
        emb = _embed(self.params, torch.from_numpy(ids).to(self.device),
                     torch.from_numpy(attn).to(self.device), self.cfg, self.layer)
        return emb, torch.from_numpy(weight).to(self.device)

    @torch.inference_mode()
    def __call__(self, pairs: List[Tuple[str, str]]) -> List[float]:
        if not pairs:
            return []
        uniq: Dict[str, int] = {}
        for a, b in pairs:
            uniq.setdefault(a, len(uniq))
            uniq.setdefault(b, len(uniq))
        emb, weight = self.embed(list(uniq))
        p_pad = _bucket(len(pairs), floor=1)
        ia = np.zeros(p_pad, np.int64)
        ib = np.zeros(p_pad, np.int64)
        for k, (a, b) in enumerate(pairs):
            ia[k], ib[k] = uniq[a], uniq[b]
        f1 = _pair_f1(emb, weight, torch.from_numpy(ia).to(self.device),
                      torch.from_numpy(ib).to(self.device))
        return [float(x) for x in f1[:len(pairs)].cpu().numpy()]


def load_bertscorer(model_dir: str, cfg: BertConfig = DISTILBERT_CONFIG,
                    layer: int = BERTSCORE_LAYER, device: DeviceLike = None) -> BERTScorer:
    """The soft-dedup scorer from a local distilbert-base-uncased directory
    (pytorch_model.bin or model.safetensors, and vocab.txt), on `device`
    (default cuda). Nothing is downloaded."""
    tokenizer = WordPieceTokenizer.from_vocab_file(os.path.join(model_dir, "vocab.txt"))
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    elif os.path.exists(st_path):
        from safetensors.torch import load_file
        sd = load_file(st_path)
    else:
        raise FileNotFoundError(f"no weights in {model_dir}")
    return BERTScorer(convert_distilbert(sd), tokenizer, cfg=cfg, layer=layer, device=device)


_DEFAULT_SCORER_CACHE: Dict[Any, BERTScorer] = {}


def default_scorer(cfg: BertConfig = DISTILBERT_CONFIG, layer: int = BERTSCORE_LAYER,
                   device: DeviceLike = None, _cache: bool = True) -> BERTScorer | None:
    """The default soft-dedup scorer on `device` (default cuda), or None
    when $RGRG_DISTILBERT_DIR does not name a local distilbert-base-uncased
    directory (reports then get exact dedup only, as in the JAX package).
    Scorers are cached per (directory, layer, config, device)."""
    model_dir = os.environ.get("RGRG_DISTILBERT_DIR", "")
    if not model_dir or not os.path.isdir(model_dir):
        return None
    dev = resolve_device(device)
    key = (model_dir, layer, cfg, str(dev))
    if _cache and key in _DEFAULT_SCORER_CACHE:
        return _DEFAULT_SCORER_CACHE[key]
    scorer = load_bertscorer(model_dir, cfg=cfg, layer=layer, device=dev)
    if _cache:
        _DEFAULT_SCORER_CACHE[key] = scorer
    return scorer

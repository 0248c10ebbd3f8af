"""Multinomial sampling decode: temperature, then top-k and nucleus (top-p)
filtering, then one categorical draw per row and step.

The output id matrix and its bookkeeping are greedy_generate's: column 0 is
BOS, finished rows receive pad, and the loop stops once every row has
finished (one host read of a bool per step). Draws come from an explicit
torch.Generator on the features' device; torch cannot replay the JAX
package's `jax.random` stream, so only the filtering is bit-for-bit the
same, and top_k=1 (one finite logit per row) decodes as greedy does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from rgrg_tpu_torch.core.config import DecoderConfig
from rgrg_tpu_torch.models import gpt2


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Keep the top_k largest logits (0: off) and then the nucleus top_p
    (1.0: off); the rest become -inf. Both cut-offs are value thresholds,
    so logits equal to the threshold stay together. The nucleus keeps
    tokens, in descending order, until the probability mass before a token
    exceeds top_p, and always keeps the top-1."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff = torch.where(cum - probs > top_p, float("-inf"), sorted_logits)
        threshold = torch.where(torch.isfinite(cutoff), cutoff,
                                float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, float("-inf"), logits)
    return logits


def sample_generate(params: Dict[str, Any], image_features: torch.Tensor,
                    generator: torch.Generator, cfg: DecoderConfig,
                    max_length: int = 300, temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0, active: Optional[torch.Tensor] = None,
                    cache_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """image_features [B, 1024] raw region features -> ids [B, max_length]
    (int64), BOS first. `generator` lives on the features' device.

    active: optional [B] bool of rows that need decoding; the others are
    born finished. cache_dtype: None follows the parameter dtype;
    torch.int8 selects the quantized cache.

    Each decode step adds one to `sample_generate.steps`."""
    b = image_features.shape[0]
    logits0, cache = gpt2.prefill(params, image_features, cfg.bos_token_id,
                                  max_length, cfg, cache_dtype=cache_dtype)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        logits = _filter_logits(logits.to(torch.float32) / temperature, top_k, top_p)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    out = torch.full((b, max_length), cfg.pad_token_id, dtype=torch.long,
                     device=image_features.device)
    out[:, 0] = cfg.bos_token_id
    token = pick(logits0)
    if active is not None:
        token = torch.where(active, token, cfg.pad_token_id)
    if max_length > 1:
        out[:, 1] = token
    unfinished = token != cfg.eos_token_id
    if active is not None:
        unfinished = unfinished & active

    t = 0
    while t < max_length - 2 and bool(unfinished.any()):
        logits, cache = gpt2.decode_step(params, token, t, cache, cfg)
        token = torch.where(unfinished, pick(logits), cfg.pad_token_id)
        out[:, t + 2] = token
        unfinished = unfinished & (token != cfg.eos_token_id)
        t += 1
        sample_generate.steps += 1
    return out


sample_generate.steps = 0

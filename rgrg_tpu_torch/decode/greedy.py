"""Greedy decoding over the static KV cache.

The output id matrix is fixed [B, max_length]: column 0 is BOS, then the
generated tokens; rows that have finished keep receiving pad (pad == eos,
skipped when decoding text). At most max_length-1 tokens are generated.
The loop stops early once every row has finished: one host read of a
bool per step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from rgrg_tpu_torch.core.config import DecoderConfig
from rgrg_tpu_torch.models import gpt2


def greedy_generate(params: Dict[str, Any], image_features: torch.Tensor,
                    cfg: DecoderConfig, max_length: int = 300,
                    active: Optional[torch.Tensor] = None,
                    cache_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """image_features [B, 1024] raw region features -> output ids
    [B, max_length] (int64).

    active: optional [B] bool of rows that need decoding; the others (the
    padding rows of a compacted selection) are born finished.
    cache_dtype: None follows the parameter dtype; torch.int8 selects the
    quantized cache."""
    b = image_features.shape[0]
    logits0, cache = gpt2.prefill(params, image_features, cfg.bos_token_id,
                                  max_length, cfg, cache_dtype=cache_dtype)
    out = torch.full((b, max_length), cfg.pad_token_id, dtype=torch.long,
                     device=image_features.device)
    out[:, 0] = cfg.bos_token_id

    token = torch.argmax(logits0, dim=-1)
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
        token = torch.where(unfinished, torch.argmax(logits, dim=-1),
                            cfg.pad_token_id)
        out[:, t + 2] = token
        unfinished = unfinished & (token != cfg.eos_token_id)
        t += 1
    return out

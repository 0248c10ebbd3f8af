"""Beam search over a KV cache that is never reordered.

Reproduces the HF (transformers 4.19) BeamSearchScorer semantics, as the
JAX package's beam_generate does:

  - per step: the top 2K of the K*V joint scores (log-softmax of each
    lane's logits plus its beam score), taken exactly in two stages (each
    lane's top 2K raw logits, then the top 2K of those K*2K candidates);
    EOS candidates ranked < K go to the finished pool, scored by the
    CURRENT length (the hypothesis without its EOS) ** length_penalty; the
    first K non-EOS candidates, in score order, continue as the live beams;
  - an item is done when its pool holds K hypotheses and, with
    early_stopping=False, the best live score max(next_scores)/cur_len^lp
    cannot beat the worst finished one;
  - finalize adds the live beams of unfinished items, takes the best
    hypothesis and appends EOS when it fits.

Ties break by the lower index everywhere, as jax.lax.top_k does
(ops/topk.stable_topk). The finished pool is a fixed [B, K] top-K set (HF's add
with eviction keeps exactly the K best, so a top-K merge is the same).
Beam reordering rewrites the [B, K, T] ancestry table, never the cache
(gpt2.decode_step_beam). The loop reads one bool per step on the host to
stop once every item is done.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from rgrg_tpu_torch.core.config import DecoderConfig
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.ops.topk import stable_topk
from rgrg_tpu_torch.utils.logging import span

NEG_INF = -1.0e9

State = Dict[str, torch.Tensor]


def init_state(batch: int, num_beams: int, max_length: int, cfg: DecoderConfig,
               device: torch.device, active: Optional[torch.Tensor] = None) -> State:
    """Live beams (ids, scores: beam 0 at 0, the others at -1e9 so the first
    step expands beam 0 only), an empty finished pool, and `done` (rows
    outside `active` are born done)."""
    k = num_beams
    out = torch.full((batch, k, max_length), cfg.pad_token_id, dtype=torch.long,
                     device=device)
    out[:, :, 0] = cfg.bos_token_id
    scores = torch.full((batch, k), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    if active is not None:
        done = done | ~active
    return {"out": out, "beam_scores": scores,
            "f_scores": torch.full((batch, k), float("-inf"), device=device),
            "f_seqs": torch.full_like(out, cfg.pad_token_id),
            "f_lens": torch.zeros((batch, k), dtype=torch.long, device=device),
            "done": done}


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, L] rows picked by idx [B, M] -> [B, M, L]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def length_penalty_divisor(cur_len: int, length_penalty: float) -> float:
    """cur_len ** length_penalty, evaluated in f32 as the JAX package does."""
    return float(torch.tensor(float(cur_len)) ** length_penalty)


def process(logits: torch.Tensor, state: State, cur_len: int, num_beams: int,
            cfg: DecoderConfig, length_penalty: float, early_stopping: bool):
    """One BeamSearchScorer.process step on logits [B*K, V]; cur_len is the
    sequence length so far (BOS included), where the new token lands.
    Returns (new_beam [B, K]: each live beam's parent beam, tokens [B*K],
    new state)."""
    k = num_beams
    out, done = state["out"], state["done"]
    b, _, max_length = out.shape
    eos, pad = cfg.eos_token_id, cfg.pad_token_id

    # per lane, log-softmax is a monotone shift of the logits: the same 2K
    # tokens win, so the joint top-2K is the top-2K of these K*2K candidates
    lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
    lane_vals, lane_idx = stable_topk(logits, 2 * k)                   # [B*K, 2K]
    cand = (lane_vals.to(torch.float32) - lse[:, None]
            + state["beam_scores"].reshape(-1, 1))
    next_scores, mi = stable_topk(cand.reshape(b, 2 * k * k), 2 * k)   # [B, 2K]
    next_beam = mi // (2 * k)
    next_tok = torch.gather(lane_idx.reshape(b, 2 * k * k), 1, mi)

    # finished pool: EOS candidates ranked < K, merged as a top-K set
    rank = torch.arange(2 * k, device=out.device)[None, :]
    is_eos = next_tok == eos
    addable = is_eos & (rank < k) & ~done[:, None]
    lp = length_penalty_divisor(cur_len, length_penalty)
    cand_scores = torch.where(addable, next_scores / lp, float("-inf"))
    merged_scores = torch.cat([state["f_scores"], cand_scores], dim=1)
    merged_seqs = torch.cat([state["f_seqs"], _take(out, next_beam)], dim=1)
    merged_lens = torch.cat([state["f_lens"], torch.full_like(next_beam, cur_len)], dim=1)
    f_scores, top_i = stable_topk(merged_scores, k)
    f_seqs = _take(merged_seqs, top_i)
    f_lens = torch.gather(merged_lens, 1, top_i)

    # live beams: the first K non-EOS candidates, in score order
    sel = torch.sort(is_eos.to(torch.int32), dim=1, stable=True).indices[:, :k]
    new_scores = torch.gather(next_scores, 1, sel)
    new_tok = torch.gather(next_tok, 1, sel)
    new_beam = torch.gather(next_beam, 1, sel)
    # done items: pad token, beam 0, score 0 (HF's convention)
    new_scores = torch.where(done[:, None], 0.0, new_scores)
    new_tok = torch.where(done[:, None], pad, new_tok)
    new_beam = torch.where(done[:, None], 0, new_beam)

    out = _take(out, new_beam)
    if cur_len < max_length:
        out[:, :, cur_len] = new_tok

    # BeamHypotheses.is_done
    finite = torch.isfinite(f_scores)
    full = finite.sum(dim=1) >= k
    if early_stopping:
        newly_done = full
    else:
        worst = torch.where(finite, f_scores, float("inf")).min(dim=1).values
        newly_done = full & (worst >= next_scores[:, 0] / lp)
    state = {"out": out, "beam_scores": new_scores, "f_scores": f_scores,
             "f_seqs": f_seqs, "f_lens": f_lens, "done": done | newly_done}
    return new_beam, new_tok.reshape(-1), state


def reorder_ancestry(anc: torch.Tensor, new_beam: torch.Tensor,
                     next_slot: int) -> torch.Tensor:
    """HF's _reorder_cache on the ancestry table [B, K, T]: live beam k
    inherits its parent's history, and the slot about to be written is its
    own lane's."""
    k, t_total = anc.shape[1], anc.shape[2]
    anc = torch.gather(anc, 1, new_beam[:, :, None].expand(-1, -1, t_total))
    if next_slot < t_total:
        anc[:, :, next_slot] = torch.arange(k, dtype=anc.dtype, device=anc.device)
    return anc


def finalize(state: State, final_len: int, cfg: DecoderConfig,
             length_penalty: float, active: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """HF finalize: live beams of unfinished items join the pool, the best
    hypothesis wins (first on ties) and gets EOS appended where it fits.
    Returns ids [B, max_length]."""
    out, done = state["out"], state["done"]
    b, k, max_length = out.shape
    lp = length_penalty_divisor(final_len, length_penalty)
    alive = torch.where(done[:, None], float("-inf"), state["beam_scores"] / lp)
    merged_scores = torch.cat([state["f_scores"], alive], dim=1)
    merged_seqs = torch.cat([state["f_seqs"], out], dim=1)
    merged_lens = torch.cat([state["f_lens"],
                             torch.full((b, k), final_len, dtype=torch.long,
                                        device=out.device)], dim=1)
    best = torch.argmax(merged_scores, dim=1)
    best_seq = _take(merged_seqs, best[:, None])[:, 0]
    best_len = torch.gather(merged_lens, 1, best[:, None])
    pos = torch.arange(max_length, device=out.device)[None, :]
    best_seq = torch.where(pos == best_len, cfg.eos_token_id, best_seq)
    best_seq = torch.where(pos > best_len, cfg.pad_token_id, best_seq)
    if active is not None:
        best_seq = torch.where(active[:, None], best_seq, cfg.pad_token_id)
    return best_seq


def beam_generate(params: Dict[str, Any], image_features: Optional[torch.Tensor],
                  cfg: DecoderConfig, max_length: int = 300, num_beams: int = 4,
                  length_penalty: float = 1.0, early_stopping: bool = False,
                  active: Optional[torch.Tensor] = None,
                  cache_dtype: Optional[torch.dtype] = None,
                  return_done: bool = False, no_image: bool = False,
                  batch: Optional[int] = None):
    """image_features [B, 1024] raw region features -> ids [B, max_length]
    (int64) of each item's best hypothesis, padded, EOS appended when it
    fits.

    active: optional [B] bool of rows to decode; the others are born done
    and come back as pad. cache_dtype: None follows the parameters;
    torch.int8 selects the quantized cache. return_done: also return the
    [B] bool `done` at loop exit: a done item's search closed before the
    cap (is_done depends on cur_len only), so its output is the same under
    any longer cap; the length-bucket cascade re-decodes only the others.
    image_features=None with `batch` B and no_image=True runs vanilla GPT-2
    (gpt2.prefill without features; the steps leave slot 0 out).

    Each call adds B to `beam_generate.rows`, each decode step one to
    `beam_generate.steps` (a `decode.step` span while spans are recorded,
    its stop test's host read a `decode.read`)."""
    k = num_beams
    if image_features is not None:
        b = image_features.shape[0]
        feats = image_features.repeat_interleave(k, dim=0)            # [B*K, F]
    else:
        b, feats = batch, None
    beam_generate.rows += b
    logits0, cache = gpt2.prefill(params, feats, cfg.bos_token_id, max_length,
                                  cfg, cache_dtype=cache_dtype,
                                  batch=None if feats is not None else b * k)
    t_total = cache["k"].shape[3]
    cache = gpt2.cache_to_beam_layers(cache)
    dev = logits0.device

    # all K lanes of an item hold the same prefill K/V (features repeated),
    # so the identity ancestry is right for slots 0-1 whatever the first
    # reorder picks
    anc = torch.arange(k, dtype=torch.int32, device=dev)[None, :, None].expand(
        b, k, t_total).contiguous()
    state = init_state(b, k, max_length, cfg, dev, active)
    lp_args = (k, cfg, length_penalty, early_stopping)
    new_beam, tok, state = process(logits0, state, 1, *lp_args)
    anc = reorder_ancestry(anc, new_beam, 2)

    t = 0
    # the reference stops once cur_len = t + 2 reaches max_length
    with span("decode.read"):
        go = t + 2 < max_length and not bool(state["done"].all())
    while go:
        with span("decode.step"):
            logits, cache = gpt2.decode_step_beam(params, tok, t, cache, anc, cfg,
                                                  no_image=no_image)
            new_beam, tok, state = process(logits, state, t + 2, *lp_args)
            anc = reorder_ancestry(anc, new_beam, t + 3)
            t += 1
            beam_generate.steps += 1
            with span("decode.read"):   # the stop test waits for the step
                go = t + 2 < max_length and not bool(state["done"].all())

    ids = finalize(state, t + 2, cfg, length_penalty, active)
    return (ids, state["done"]) if return_done else ids


beam_generate.steps = 0
beam_generate.rows = 0

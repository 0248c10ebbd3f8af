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
(decode_step_beam). The loop reads one bool per step on the host to
stop once every item is done.

The decoder is the module of models/ that the config names
(models.decoder_module: GPT-2 or Moonlight). On the card the steps replay
from CUDA graphs (StepGraphs): a decode shape seen the second time gets a
set of fixed buffers, its step held on the device, and the step captured
as one graph per stretch between two launches of kernel K3, which stays
eager (GPT-2), or as one graph (Moonlight, whose attention is plain torch
ops). At most two sets are kept, least recently used evicted first. CPU
tensors run the eager step.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional

import torch

from rgrg_tpu_torch.core.config import DecoderConfig
from rgrg_tpu_torch.models import decoder_module
from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8
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


def _over(x: torch.Tensor, lp) -> torch.Tensor:
    """x / lp, the divisor a host float or a one-element f32 tensor (the
    graph-ready step). On CUDA `x / float` multiplies by the divisor's f32
    reciprocal, so the tensor does the same there: a replayed step rounds
    as an eager one."""
    if isinstance(lp, float) or not x.is_cuda:
        return x / lp
    return x * torch.reciprocal(lp)


def process(logits: torch.Tensor, state: State, cur_len, num_beams: int,
            cfg: DecoderConfig, length_penalty: float, early_stopping: bool,
            lp_table: Optional[torch.Tensor] = None):
    """One BeamSearchScorer.process step on logits [B*K, V]; cur_len is the
    sequence length so far (BOS included), where the new token lands.
    Returns (new_beam [B, K]: each live beam's parent beam, tokens [B*K],
    new state).

    The graph-ready step passes cur_len as a one-element int64 tensor on
    the device and lp_table [max_length] f32, the divisors by cur_len; its
    caller holds cur_len < max_length."""
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
    on_host = isinstance(cur_len, int)
    lp = length_penalty_divisor(cur_len, length_penalty) if on_host else lp_table[cur_len]
    cand_scores = torch.where(addable, _over(next_scores, lp), float("-inf"))
    merged_scores = torch.cat([state["f_scores"], cand_scores], dim=1)
    merged_seqs = torch.cat([state["f_seqs"], _take(out, next_beam)], dim=1)
    lens = torch.full_like(next_beam, cur_len) if on_host else cur_len.expand_as(next_beam)
    merged_lens = torch.cat([state["f_lens"], lens], dim=1)
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
    if not on_host:
        out.index_copy_(2, cur_len, new_tok[:, :, None])
    elif cur_len < max_length:
        out[:, :, cur_len] = new_tok

    # BeamHypotheses.is_done
    finite = torch.isfinite(f_scores)
    full = finite.sum(dim=1) >= k
    if early_stopping:
        newly_done = full
    else:
        worst = torch.where(finite, f_scores, float("inf")).min(dim=1).values
        newly_done = full & (worst >= _over(next_scores[:, 0], lp))
    state = {"out": out, "beam_scores": new_scores, "f_scores": f_scores,
             "f_seqs": f_seqs, "f_lens": f_lens, "done": done | newly_done}
    return new_beam, new_tok.reshape(-1), state


def reorder_ancestry(anc: torch.Tensor, new_beam: torch.Tensor,
                     next_slot) -> torch.Tensor:
    """HF's _reorder_cache on the ancestry table [B, K, T]: live beam k
    inherits its parent's history, and the slot about to be written is its
    own lane's. next_slot: a host int, or a one-element int64 tensor on
    the device (the graph-ready step, whose caller holds next_slot < T)."""
    b, k, t_total = anc.shape
    anc = torch.gather(anc, 1, new_beam[:, :, None].expand(-1, -1, t_total))
    own = torch.arange(k, dtype=anc.dtype, device=anc.device)
    if not isinstance(next_slot, int):
        anc.index_copy_(2, next_slot, own[None, :, None].expand(b, k, 1))
    elif next_slot < t_total:
        anc[:, :, next_slot] = own
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


class StepGraphs:
    """The beam step of one decode shape in graph-ready form, over fixed
    buffers that its decodes share.

    Every per-step value the step's device work uses is held on the
    device: `idx` = (position id, cache slot = cur_len, next slot), which
    the step advances itself, and the length-penalty divisors in a table
    indexed by cur_len. The tokens, the ancestry, the beam state and each
    layer's cache (the decoder module's `beam_buffers`) are buffers of the
    set, updated in place. Where the decoder's attention is eager (GPT-2's
    K3, gpt2.beam_layer_attention, which takes its slot as a host int:
    `step`'s argument, which must equal idx[1]) the step runs as
    num_layers + 1 segments around its launches: segment 0 embeds and runs
    layer 0 to its cache write; segment i runs layer i-1 from its
    attention on and layer i to its cache write; the last runs the last
    layer's tail, the logits, `process` and `reorder_ancestry`. Otherwise
    (Moonlight) the step is one segment: the embedding, `beam_layers`, the
    logits, `process` and `reorder_ancestry`.

    On CUDA `capture` runs one step eagerly on a side stream, then records
    each segment as a CUDA graph in replay order into one private memory
    pool, and `step` replays them; until then, and on the CPU, `step` runs
    the segments eagerly. A decode copies in only the two slots prefill
    writes; a step writes its slot before K3 reads it, and K3 reads only
    slots t0..slot, so the rows past the slot (an earlier decode's) are
    never read."""

    def __init__(self, params: Dict[str, Any], cfg: DecoderConfig, items: int,
                 num_beams: int, max_length: int, cache_dtype: torch.dtype,
                 length_penalty: float, early_stopping: bool, no_image: bool):
        wte = params["wte"]["embedding"]
        dev, k = wte.device, num_beams
        bk, t_total = items * k, max_length + 1
        self.mod = decoder_module(cfg)
        self.params, self.cfg, self.max_length = params, cfg, max_length
        self.lp_args = (k, cfg, length_penalty, early_stopping)
        self.eager_attention = self.mod.BEAM_ATTENTION_EAGER
        self.segments = cfg.num_layers + 1 if self.eager_attention else 1
        if self.eager_attention:
            self.scale = self.mod._attn_scale(cfg.head_dim, wte.dtype)
        self.t0 = 1 if no_image else 0
        bufs = self.mod.beam_buffers(params, cfg, bk, t_total, cache_dtype)
        self.cache, self.q, self.ctx = bufs["cache"], bufs.get("q"), bufs.get("ctx")
        self.tok = torch.empty(bk, dtype=torch.long, device=dev)
        self.anc = torch.empty((items, k, t_total), dtype=torch.int32, device=dev)
        self.state = init_state(items, k, max_length, cfg, dev)
        self.idx = torch.empty(3, dtype=torch.long, device=dev)
        self._idx0 = torch.tensor([1, 2, 3], device=dev)
        self.lp = torch.tensor([length_penalty_divisor(n, length_penalty)
                                for n in range(max_length)], device=dev)
        self.lock = threading.Lock()   # one decode at a time over the buffers
        self.graphs = None
        self._k4 = None
        self._x = None

    def load(self, tok: torch.Tensor, anc: torch.Tensor, state: State) -> None:
        """Starts a decode at step 0 from the first `process`'s tokens,
        ancestry and state (its cache: cache_to_beam_layers(out=cache))."""
        self.tok.copy_(tok)
        self.anc.copy_(anc)
        for name, v in state.items():
            self.state[name].copy_(v)
        self.idx.copy_(self._idx0)

    def _segment(self, i: int) -> None:
        m, p, cfg = self.mod, self.params, self.cfg
        pos, slot, nxt = self.idx[0:1], self.idx[1:2], self.idx[2:3]
        if i == 0:
            x = m.beam_embed(p, self.tok, pos, cfg)
        else:
            x = m.beam_layer_out(p, i - 1, self._x, self.ctx, cfg)
        if not self.eager_attention:
            x = m.beam_layers(p, x, self.cache, slot, self.anc, cfg)
        elif i < cfg.num_layers:
            m.beam_layer_in(p, i, x, self.cache, slot, cfg, q_out=self.q)
            self._x = x   # the next segment's input (from the pool while capturing)
            return
        self._x = None
        new_beam, tok, state = process(m._logits(p, x, cfg), self.state, slot,
                                       *self.lp_args, lp_table=self.lp)
        self.anc.copy_(reorder_ancestry(self.anc, new_beam, nxt))
        self.tok.copy_(tok)
        for name, v in state.items():
            self.state[name].copy_(v)
        self.idx.add_(1)

    def step(self, slot: int) -> bool:
        """One decode step writing cache slot `slot` (cur_len); True when it
        was replayed from the graphs."""
        assert slot < self.max_length, "the loop decodes while cur_len < max_length"
        for i in range(self.segments):
            if self.graphs is None:
                self._segment(i)
            else:
                self.graphs[i].replay()
                dense_wint8.launches += self._k4[i]
            if i < self.segments - 1:
                self.mod.beam_layer_attention(self.cache, i, self.q, self.anc, slot,
                                              self.scale, self.t0, out=self.ctx)
        return self.graphs is not None

    def capture(self, slot: int) -> None:
        """The decode step at `slot`, run eagerly on a side stream (the
        warm-up the CUDA graph docs ask for), then each segment captured
        there. Captures record K4 launches without running them:
        `dense_wint8.launches` counts them at each replay instead."""
        dev = self.idx.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        graphs, k4 = [], []
        with torch.cuda.stream(side):
            self.step(slot)
            pool = torch.cuda.graph_pool_handle()
            for i in range(self.segments):
                g = torch.cuda.CUDAGraph()
                before = dense_wint8.launches
                # thread_local: the serving loop's pre and post threads keep
                # copying and allocating on the default stream meanwhile
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self._segment(i)
                finally:
                    g.capture_end()
                graphs.append(g)
                k4.append(dense_wint8.launches - before)
                dense_wint8.launches = before
        cur.wait_stream(side)
        self.graphs, self._k4 = graphs, k4


class _GraphSets:
    """StepGraphs by decode key: a key is given a set the second time it is
    seen (a one-off shape decodes eagerly), and at most `keep` sets are
    held, the least recently used evicted first (its memory freed with it)."""

    def __init__(self, keep: int = 2, remember: int = 64):
        self.keep, self.remember = keep, remember
        self.sets = collections.OrderedDict()
        self.seen = collections.OrderedDict()
        self.lock = threading.Lock()

    def get(self, key, make) -> Optional[StepGraphs]:
        with self.lock:
            if key in self.sets:
                self.sets.move_to_end(key)
                return self.sets[key]
            if self.seen.pop(key, None) is None:
                self.seen[key] = True
                while len(self.seen) > self.remember:
                    self.seen.popitem(last=False)
                return None
            while len(self.sets) >= self.keep:
                self.sets.popitem(last=False)
            made = self.sets[key] = make()
            return made

    def clear(self) -> None:
        with self.lock:
            self.sets.clear()
            self.seen.clear()


GRAPH_SETS = _GraphSets()


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)


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
    (gpt2.prefill without features; the steps leave slot 0 out; the
    Moonlight decoder raises NotImplementedError).

    On CUDA a decode key (lanes, cache slots and dtype, the parameters'
    dtype and tensors, beams, length penalty, early stopping, no_image, the
    config) seen before decodes through its StepGraphs (GRAPH_SETS).

    Each call adds B to `beam_generate.rows`, each decode step one to
    `beam_generate.steps` (a `decode.step` span while spans are recorded,
    its stop test's host read a `decode.read`); a step replayed from CUDA
    graphs adds one to `beam_generate.graph_steps`, each set captured one
    to `beam_generate.graph_captures` (its first step, run eagerly while
    capturing, in a `decode.capture` span)."""
    b = image_features.shape[0] if image_features is not None else batch
    beam_generate.rows += b
    kw = dict(max_length=max_length, num_beams=num_beams, length_penalty=length_penalty,
              early_stopping=early_stopping, active=active, cache_dtype=cache_dtype,
              return_done=return_done, no_image=no_image)
    wte = params["wte"]["embedding"]
    graphs = None
    if wte.is_cuda:
        kv = wte.dtype if cache_dtype is None else cache_dtype
        key = (wte.device, b * num_beams, num_beams, max_length, kv, wte.dtype,
               length_penalty, early_stopping, no_image, cfg,
               tuple(x.data_ptr() for x in _leaves(params)))
        graphs = GRAPH_SETS.get(key, lambda: StepGraphs(
            params, cfg, b, num_beams, max_length, kv, length_penalty, early_stopping,
            no_image))
    if graphs is not None and graphs.lock.acquire(blocking=False):
        try:
            return _decode(params, image_features, b, cfg, graphs, **kw)
        finally:
            graphs.lock.release()
    return _decode(params, image_features, b, cfg, None, **kw)


def _decode(params, image_features, b: int, cfg: DecoderConfig,
            graphs: Optional[StepGraphs], *, max_length, num_beams, length_penalty,
            early_stopping, active, cache_dtype, return_done, no_image):
    """beam_generate's prefill and search over b items; the steps through
    `graphs` when given (its segments eagerly until captured; on CUDA its
    first step captures)."""
    k = num_beams
    mod = decoder_module(cfg)
    feats = None if image_features is None else image_features.repeat_interleave(k, dim=0)
    # into a set's cache only the two slots prefill writes are copied: a step
    # writes its slot before any read of it
    logits0, cache = mod.prefill(params, feats, cfg.bos_token_id,
                                  max_length if graphs is None else 1, cfg,
                                  cache_dtype=cache_dtype,
                                  batch=None if feats is not None else b * k)
    t_total = max_length + 1
    cache = mod.cache_to_beam_layers(cache, out=None if graphs is None else graphs.cache)
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
    if graphs is not None:
        graphs.load(tok, anc, state)
        state = graphs.state

    t = 0
    # the reference stops once cur_len = t + 2 reaches max_length
    with span("decode.read"):
        go = t + 2 < max_length and not bool(state["done"].all())
    while go:
        with span("decode.step"):
            if graphs is None:
                logits, cache = mod.decode_step_beam(params, tok, t, cache, anc, cfg,
                                                     no_image=no_image)
                new_beam, tok, state = process(logits, state, t + 2, *lp_args)
                anc = reorder_ancestry(anc, new_beam, t + 3)
            elif graphs.graphs is None and dev.type == "cuda":
                with span("decode.capture"):
                    graphs.capture(t + 2)
                beam_generate.graph_captures += 1
            else:
                beam_generate.graph_steps += graphs.step(t + 2)
            t += 1
            beam_generate.steps += 1
            with span("decode.read"):   # the stop test waits for the step
                go = t + 2 < max_length and not bool(state["done"].all())

    ids = finalize(state, t + 2, cfg, length_penalty, active)
    if not return_done:
        return ids
    # the set's buffer is the next decode's
    return ids, state["done"] if graphs is None else state["done"].clone()


beam_generate.steps = 0
beam_generate.rows = 0
beam_generate.graph_steps = 0
beam_generate.graph_captures = 0

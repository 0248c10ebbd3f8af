"""Moonlight-16B-A3B's DeepSeek-V3 block as RGRG's sentence decoder: the
generation path (prefill, the greedy step, the beam step's pieces) over a
latent cache.

The block, on the residual stream h [N, D]:

  - a = RMSNorm(h); q = a W_q -> [N, H, dn + dr], its last dr dims rotated
    (RoPE at the token's cache slot); kv = a W_kva -> [N, R + dr]: the
    latent c = RMSNorm_kv(kv[:R]) and the key's shared RoPE part
    k_pe = rope(kv[R:]);
  - W_kvb [R, H (dn + dv)] holds per head W_uk [R, dn] and W_uv [R, dv]:
    score(h, t) = (q_nope[h] . c_t W_uk[h] + q_pe[h] . k_pe_t) / sqrt(dn + dr),
    o[h] = sum_t softmax(score)_t c_t W_uv[h]; h += concat(o) W_o;
  - m = RMSNorm(h); layer 0 (first_k_dense_replace) adds a SwiGLU, the
    others the routed and shared experts (ops/moe.py);
  - logits = RMSNorm(h) W_head (untied).

RGRG's pseudo self-attention enters as the latent: the region feature
goes through the feature transform (1024 -> D -> D), each layer's W_img
[D, R + dr] maps it to a cache row whose first R dims are normalised by
RMSNorm_kv, held in slot 0 and never masked (its rotation at position 0
is the identity). BOS sits in slot 1, generated token t in slot t + 2,
and the RoPE position is the slot.

The cache holds one row of R + dr = 576 a lane and slot for all heads
(`kv_<layer>` [N, T, R + dr], in the weights' dtype), written in place.
Attention runs in absorbed form everywhere, prefill included:
q_lat[h] = W_uk[h] q_nope[h] and the score is [q_lat, q_pe] . row_t;
o_lat = sum_t p_t c_t, then o[h] = o_lat W_uv[h]. Scores come from a
product in the weights' dtype and the softmax is taken in f32. Beam
search reads the rows its ancestry names ([B, K, T], as kernel K3 reads
it): each lane scores its item's K x T rows and masks those that are not
its ancestry's, so the step needs no gather and no host value and runs
inside one CUDA graph (decode/beam.StepGraphs: BEAM_ATTENTION_EAGER is
False, so the whole step is one segment around `beam_layers`). What the
layers of a step share (RoPE's angles, the mask) is made once a step.

Params (kernels [in, out], no biases but the feature transform's):
"wte" {"embedding" [V, D]}, "feature_transform" (as gpt2's), "norm" [D],
"lm_head" [D, V], and per layer "h_<i>": "input_norm" [D], "post_norm" [D],
"attn" {"q", "kva", "kv_norm" [R], "kvb", "o", "img"}, then "mlp"
{"gate_up" [D, 2 I], "down" [I, D]} or "moe" {"router" [E, D], "bias" [E]
(the correction), "gate_up" [E, D, 2 Im], "down" [E, Im, D],
"shared_gate_up" [D, 2 Is], "shared_down" [Is, D]}.

Not here: vanilla decoding without the image (no_image), sampling, int8
weights or an int8 cache, and training (forward_full).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from rgrg_tpu_torch.core.config import MoonlightConfig
from rgrg_tpu_torch.models.gpt2 import feature_transform
from rgrg_tpu_torch.ops import moe as moe_ops
from rgrg_tpu_torch.utils.logging import span

Params = Dict[str, Any]

# the beam step's attention is plain torch ops, captured with the rest
BEAM_ATTENTION_EAGER = False


def _unsupported(what: str):
    return NotImplementedError(f"{what} is not implemented for the Moonlight (MLA/MoE) decoder")


def init_decoder_params(generator: torch.Generator, cfg: MoonlightConfig,
                        dtype: torch.dtype = torch.float32,
                        device: Optional[torch.device] = None) -> Params:
    """Random init: N(0, 0.02) matrices and correction biases, unit norm
    scales, zero feature-transform biases. Draws come from `generator`,
    which must live on `device`."""
    device = generator.device if device is None else device

    def n(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype) * 0.02

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    d, h, r = cfg.hidden_dim, cfg.num_heads, cfg.kv_lora_rank
    e, im = cfg.n_routed_experts, cfg.moe_intermediate_size
    params: Params = {
        "wte": {"embedding": n(cfg.vocab_size, d)},
        "feature_transform": {
            "fc0": {"kernel": n(cfg.image_feature_dim, d),
                    "bias": torch.zeros(d, dtype=dtype, device=device)},
            "fc1": {"kernel": n(d, d), "bias": torch.zeros(d, dtype=dtype, device=device)},
        },
        "norm": ones(d),
        "lm_head": n(d, cfg.vocab_size),
    }
    for i in range(cfg.num_layers):
        layer = {"input_norm": ones(d), "post_norm": ones(d),
                 "attn": {"q": n(d, h * cfg.head_dim), "kva": n(d, cfg.latent_dim),
                          "kv_norm": ones(r),
                          "kvb": n(r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                          "o": n(h * cfg.v_head_dim, d), "img": n(d, cfg.latent_dim)}}
        if i < cfg.first_k_dense_replace:
            layer["mlp"] = {"gate_up": n(d, 2 * cfg.intermediate_size),
                            "down": n(cfg.intermediate_size, d)}
        else:
            shared = im * cfg.n_shared_experts
            layer["moe"] = {"router": n(e, d), "bias": n(e), "gate_up": n(e, d, 2 * im),
                            "down": n(e, im, d), "shared_gate_up": n(d, 2 * shared),
                            "shared_down": n(shared, d)}
        params[f"h_{i}"] = layer
    return params


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, returned in x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def _step(slot, slots: int, cfg: MoonlightConfig, device: torch.device,
          ancestry: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """What every layer of one step shares, made once a step. slot: the
    cache slot written (a host int, or a one-element int64 tensor on the
    device: the graph-ready step); slots: the cache's length. Holds RoPE's
    cos and sin at the slot (f32, inv_freq_i = theta^(-2i / dr)), the slots
    attention reads ("t": 0..slot for a host int, else all of them, the
    later ones masked) and the mask [B, K, 1, K, t] of the rows each lane
    reads: lane b*K + k, at slot t, the row of lane b*K + ancestry[b, k, t]
    (ancestry [B, K, T]); without ancestry each lane its own rows (K = 1)."""
    dr = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, dr, 2, dtype=torch.float32,
                                                 device=device) / dr))
    if isinstance(slot, int):
        f, t = inv * float(slot), slot + 1
    else:
        f, t = slot.to(torch.float32).reshape(-1)[:1] * inv, slots
    ang = torch.cat([f, f])
    live = torch.arange(t, device=device) <= slot
    if ancestry is None:
        valid = live.view(1, 1, 1, 1, t)
    else:
        src = torch.arange(ancestry.shape[1], device=device, dtype=ancestry.dtype)
        valid = ((ancestry[:, :, None, :t] == src[None, None, :, None]) & live)[:, :, None]
    return {"slot": slot, "cos": torch.cos(ang), "sin": torch.sin(ang), "t": t, "valid": valid}


def rope(x: torch.Tensor, step: Dict[str, Any]) -> torch.Tensor:
    """Rotate-half RoPE over x's last dim (qk_rope_head_dim wide) at the
    step's slot, in f32, returned in x's dtype."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * step["cos"] + rot * step["sin"]).to(x.dtype)


def _heads(kvb: torch.Tensor, cfg: MoonlightConfig):
    """W_uk^T [H, dn, R] and W_uv [H, R, dv] as views of W_kvb [R, H (dn + dv)]."""
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    w = kvb.view(r, cfg.num_heads, dn + cfg.v_head_dim)
    return w[:, :, :dn].permute(1, 2, 0), w[:, :, dn:].permute(1, 0, 2)


def _write_slot(buf: torch.Tensor, slot, row: torch.Tensor) -> None:
    """buf[:, slot] = row for buf [N, T, C]; slot a host int or a
    one-element int64 tensor on buf's device."""
    if isinstance(slot, int):
        buf[:, slot] = row
    else:
        buf.index_copy_(1, slot, row.to(buf.dtype).unsqueeze(1))


def _queries(p: Params, x: torch.Tensor, step: Dict[str, Any], cfg: MoonlightConfig):
    """Layer p's attention front on x [N, D]: the absorbed queries
    [N, H, R + dr] and the token's latent cache row [N, R + dr]."""
    n = x.shape[0]
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    a = rms_norm(x, p["input_norm"], cfg.layer_norm_eps)
    q = (a @ p["attn"]["q"]).view(n, cfg.num_heads, cfg.head_dim)
    kv = a @ p["attn"]["kva"]
    c = rms_norm(kv[:, :r], p["attn"]["kv_norm"], cfg.layer_norm_eps)
    row = torch.cat([c, rope(kv[:, r:], step)], dim=-1)
    uk_t, _ = _heads(p["attn"]["kvb"], cfg)
    q_lat = torch.bmm(q[:, :, :dn].transpose(0, 1), uk_t).transpose(0, 1)   # [N, H, R]
    return torch.cat([q_lat, rope(q[:, :, dn:], step)], dim=-1), row


def attend(q: torch.Tensor, kv: torch.Tensor, step: Dict[str, Any],
           cfg: MoonlightConfig) -> torch.Tensor:
    """Absorbed attention: q [N, H, R + dr] over the step's slots of cache
    rows kv [N, T, R + dr], each lane's rows as the step's mask names them.
    Returns o_lat [N, H, R] in kv's dtype."""
    with span("mla.attend"):
        n, h, width = q.shape
        t, valid = step["t"], step["valid"]
        k = valid.shape[3]
        b = n // k
        rows = kv[:, :t].reshape(b, k * t, width)
        s = torch.bmm(q.reshape(b, k * h, width), rows.transpose(1, 2)).float()
        s = s * (1.0 / math.sqrt(cfg.head_dim))
        s = s.view(b, k, h, k, t).masked_fill(~valid, float("-inf")).view(b, k * h, k * t)
        probs = torch.softmax(s, dim=-1).to(kv.dtype)
        return torch.bmm(probs, rows[..., :cfg.kv_lora_rank]).view(n, h, cfg.kv_lora_rank)


def _out(p: Params, x: torch.Tensor, o_lat: torch.Tensor, cfg: MoonlightConfig,
         i: int, counters: Optional[torch.Tensor]) -> torch.Tensor:
    """Layer p after its attention: o = o_lat W_uv per head, W_o, the
    residual, then the dense SwiGLU or the experts and their residual."""
    n = x.shape[0]
    _, uv = _heads(p["attn"]["kvb"], cfg)
    o = torch.bmm(o_lat.to(x.dtype).transpose(0, 1), uv).transpose(0, 1).reshape(n, -1)
    x = x + o @ p["attn"]["o"]
    m = rms_norm(x, p["post_norm"], cfg.layer_norm_eps)
    if "mlp" in p:
        return x + moe_ops.swiglu(m, p["mlp"]["gate_up"], p["mlp"]["down"])
    return x + moe_ops.moe(m, p["moe"], cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                           cfg.norm_topk_prob, counters, i - cfg.first_k_dense_replace)


def _counters(params: Params, cfg: MoonlightConfig) -> torch.Tensor:
    return moe_ops.expert_counters(params["wte"]["embedding"].device, cfg.num_moe_layers,
                                   cfg.n_routed_experts)


def _logits(params: Params, x: torch.Tensor, cfg: MoonlightConfig) -> torch.Tensor:
    """[N, D] -> [N, V] in x's dtype."""
    return rms_norm(x, params["norm"], cfg.layer_norm_eps) @ params["lm_head"]


def _layer(params: Params, i: int, x: torch.Tensor, cache: Dict[str, torch.Tensor],
           step: Dict[str, Any], cfg: MoonlightConfig) -> torch.Tensor:
    p = params[f"h_{i}"]
    q, row = _queries(p, x, step, cfg)
    _write_slot(cache[f"kv_{i}"], step["slot"], row)
    o_lat = attend(q, cache[f"kv_{i}"], step, cfg)
    return _out(p, x, o_lat, cfg, i, _counters(params, cfg))


def prefill(params: Params, image_features: Optional[torch.Tensor], bos_token: int,
            max_len: int, cfg: MoonlightConfig, cache_dtype: Optional[torch.dtype] = None,
            batch: Optional[int] = None):
    """Start generation: each layer's image row into slot 0 and BOS's into
    slot 1 (absorbed attention over both). Returns (logits [B, V] at BOS,
    cache {"kv_<i>": [B, 1 + max_len, R + dr]})."""
    if image_features is None:
        raise _unsupported("decoding without image features (no_image)")
    wte = params["wte"]["embedding"]
    if cache_dtype not in (None, wte.dtype):
        raise _unsupported(f"a {cache_dtype} latent cache")
    b, r = image_features.shape[0], cfg.kv_lora_rank
    f = feature_transform(params, image_features.to(wte.dtype))
    cache = {f"kv_{i}": torch.zeros((b, 1 + max_len, cfg.latent_dim), dtype=wte.dtype,
                                    device=wte.device) for i in range(cfg.num_layers)}
    x = wte[torch.full((b,), bos_token, dtype=torch.long, device=wte.device)]
    step = _step(1, 1 + max_len, cfg, wte.device)
    for i in range(cfg.num_layers):
        attn = params[f"h_{i}"]["attn"]
        img = f @ attn["img"]
        cache[f"kv_{i}"][:, 0] = torch.cat(
            [rms_norm(img[:, :r], attn["kv_norm"], cfg.layer_norm_eps), img[:, r:]], dim=-1)
        x = _layer(params, i, x, cache, step, cfg)
    return _logits(params, x, cfg), cache


def decode_step(params: Params, token: torch.Tensor, step: int,
                cache: Dict[str, torch.Tensor], cfg: MoonlightConfig, no_image: bool = False):
    """One greedy step: token [B], generated at position `step`, into cache
    slot step + 2. Returns (logits [B, V], cache)."""
    if no_image:
        raise _unsupported("decoding without image features (no_image)")
    x = params["wte"]["embedding"][token]
    st = _step(step + 2, cache["kv_0"].shape[1], cfg, x.device)
    for i in range(cfg.num_layers):
        x = _layer(params, i, x, cache, st, cfg)
    return _logits(params, x, cfg), cache


# ------------------------------------------------------------ beam search

def cache_to_beam_layers(cache: Dict[str, torch.Tensor],
                         out: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Dict[str, torch.Tensor]:
    """The prefill cache is already one [B*K, T, R + dr] buffer a layer;
    out: a step graph set's buffers, whose first T slots take it."""
    if out is None:
        return cache
    for name, c in cache.items():
        out[name][:, :c.shape[1]].copy_(c)
    return out


def beam_buffers(params: Params, cfg: MoonlightConfig, lanes: int, slots: int,
                 cache_dtype: torch.dtype) -> Dict[str, Any]:
    """A step graph set's fixed buffers: each layer's cache [lanes, slots,
    R + dr] (the step's attention runs inside its graph: no query or
    context buffers). Zeroed: the graph-ready step scores every slot and
    gives the rows past its slot weight 0, which must meet finite values
    (an earlier decode's rows, or these zeros), never NaN from unwritten
    memory."""
    wte = params["wte"]["embedding"]
    if cache_dtype != wte.dtype:
        raise _unsupported(f"a {cache_dtype} latent cache")
    return {"cache": {f"kv_{i}": torch.zeros((lanes, slots, cfg.latent_dim), dtype=wte.dtype,
                                             device=wte.device)
                      for i in range(cfg.num_layers)}}


def beam_embed(params: Params, token: torch.Tensor, position, cfg: MoonlightConfig
               ) -> torch.Tensor:
    """The beam step's input [B*K, D] (RoPE takes the position from the
    slot)."""
    return params["wte"]["embedding"][token]


def beam_layers(params: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor], slot,
                ancestry: torch.Tensor, cfg: MoonlightConfig) -> torch.Tensor:
    """Every layer of a beam step on x [B*K, D]: each token's latent row
    into cache `slot` (a host int or a one-element int64 tensor), attention
    through `ancestry` [B, K, T], the experts."""
    st = _step(slot, cache["kv_0"].shape[1], cfg, x.device, ancestry)
    for i in range(cfg.num_layers):
        x = _layer(params, i, x, cache, st, cfg)
    return x


def decode_step_beam(params: Params, token: torch.Tensor, step: int,
                     cache: Dict[str, torch.Tensor], ancestry: torch.Tensor,
                     cfg: MoonlightConfig, no_image: bool = False):
    """One beam step, token [B*K] into cache slot step + 2, every layer's
    attention through `ancestry` [B, K, T]. Returns (logits [B*K, V],
    cache)."""
    if no_image:
        raise _unsupported("decoding without image features (no_image)")
    x = beam_layers(params, params["wte"]["embedding"][token], cache, step + 2, ancestry, cfg)
    return _logits(params, x, cfg), cache

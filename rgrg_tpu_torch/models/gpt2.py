"""GPT-2 decoder with pseudo self-attention: the KV-cached generation path.

Plain functions over a parameter dict of tensors (the JAX package's tree,
same keys and layouts):

  - every layer's K/V has one extra leading slot (slot 0) holding a
    projection (uk/uv) of the image region feature; the causal mask never
    hides it;
  - c_attn/c_proj/c_fc are GPT-2 Conv1D layers, kernels stored [in, out]
    and used as is;
  - position embeddings come from the WORD embedding table when
    cfg.positions_from_wte (a quirk the published checkpoints carry);
  - the LM head is tied to wte; masked attention scores get -1e4.

The KV cache is a static [L, B, H, 1+T, D] buffer (bf16/f32, or int8 with
per-(layer, row, head, slot) absmax scales) that decode_step updates in
place: one slot per layer per step, no reallocation.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from rgrg_tpu_torch.core.config import DecoderConfig

Params = Dict[str, Any]

MASK_VALUE = -1e4


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    """y = x @ kernel + bias with the kernel stored [in, out]."""
    return torch.matmul(x, p["kernel"]) + p["bias"]


def _layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximated GELU."""
    return F.gelu(x, approximate="tanh")


def _split_heads(x: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """[..., S, H*D] -> [..., H, S, D]"""
    return x.reshape(x.shape[:-1] + (num_heads, head_dim)).transpose(-3, -2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, S, D] -> [..., S, H*D]"""
    y = x.transpose(-3, -2)
    return y.reshape(y.shape[:-2] + (-1,))


def init_decoder_params(generator: torch.Generator, cfg: DecoderConfig,
                        dtype: torch.dtype = torch.float32,
                        device: Optional[torch.device] = None) -> Params:
    """Random init with GPT-2 conventions: N(0, 0.02) weights, zero biases,
    unit layer-norm scales. Draws come from `generator`, which must live on
    `device`."""
    device = generator.device if device is None else device

    def n(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype) * 0.02

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ln():
        return {"scale": torch.ones(cfg.hidden_dim, dtype=dtype, device=device),
                "bias": z(cfg.hidden_dim)}

    d = cfg.hidden_dim
    params: Params = {
        "wte": {"embedding": n(cfg.vocab_size, d)},
        "wpe": {"embedding": n(cfg.max_positions, d)},
        "ln_f": ln(),
        "feature_transform": {
            "fc0": {"kernel": n(cfg.image_feature_dim, d), "bias": z(d)},
            "fc1": {"kernel": n(d, d), "bias": z(d)},
        },
    }
    for i in range(cfg.num_layers):
        params[f"h_{i}"] = {
            "ln_1": ln(),
            "ln_2": ln(),
            "attn": {
                "c_attn": {"kernel": n(d, 3 * d), "bias": z(3 * d)},
                "c_proj": {"kernel": n(d, d), "bias": z(d)},
                "uk": {"kernel": n(d, d), "bias": z(d)},
                "uv": {"kernel": n(d, d), "bias": z(d)},
            },
            "mlp": {
                "c_fc": {"kernel": n(d, 4 * d), "bias": z(4 * d)},
                "c_proj": {"kernel": n(4 * d, d), "bias": z(d)},
            },
        }
    return params


def feature_transform(params: Params, image_features: torch.Tensor) -> torch.Tensor:
    """Image-feature space -> text-feature space MLP, [N, 1024] -> [N, D]."""
    p = params["feature_transform"]
    return _dense(F.relu(_dense(image_features, p["fc0"])), p["fc1"])


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """q [B,H,S,D] x k/v [B,H,T,D] with additive bias [.., S, T] (0 or -1e4)."""
    d = v.shape[-1]
    # 1/sqrt(D) evaluated in the query's dtype, as the reference does
    scale = torch.tensor(float(d), dtype=q.dtype).sqrt().reciprocal().item()
    w = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    w = torch.softmax(w + bias, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bhtd->bhsd", w, v)


def _positions_embed(params: Params, position_ids: torch.Tensor,
                     cfg: DecoderConfig) -> torch.Tensor:
    table = params["wte" if cfg.positions_from_wte else "wpe"]["embedding"]
    return table[position_ids]


def init_cache(batch: int, max_len: int, cfg: DecoderConfig,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Static cache: slot 0 = image K/V, slots 1..max_len = tokens.
    dtype int8 adds per-slot absmax scales; decode dequantizes on read."""
    shape = (cfg.num_layers, batch, cfg.num_heads, 1 + max_len, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        sshape = shape[:-1] + (1,)
        cache["k_scale"] = torch.ones(sshape, dtype=torch.float32, device=device)
        cache["v_scale"] = torch.ones(sshape, dtype=torch.float32, device=device)
    return cache


def _quantize_kv(x: torch.Tensor):
    """Per-vector absmax int8 over the head dim: round half to even, scale
    floored at 1e-8."""
    xf = x.to(torch.float32)
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return torch.round(xf / s).to(torch.int8), s


def _cache_write(cache: Dict[str, torch.Tensor], layer: int, slots: slice,
                 k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k/v [B, H, S, D] into cache slots of one layer, in place
    (quantizing for an int8 cache)."""
    if cache["k"].dtype == torch.int8:
        qk, sk = _quantize_kv(k)
        qv, sv = _quantize_kv(v)
        cache["k"][layer, :, :, slots] = qk
        cache["v"][layer, :, :, slots] = qv
        cache["k_scale"][layer, :, :, slots] = sk
        cache["v_scale"][layer, :, :, slots] = sv
    else:
        cache["k"][layer, :, :, slots] = k.to(cache["k"].dtype)
        cache["v"][layer, :, :, slots] = v.to(cache["v"].dtype)


def _cache_read(cache: Dict[str, torch.Tensor], name: str, layer: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Dequantizing read of one layer's K or V: [B, H, T, D]."""
    raw = cache[name][layer]
    if raw.dtype == torch.int8:
        return (raw.to(torch.float32) * cache[f"{name}_scale"][layer]).to(out_dtype)
    return raw.to(out_dtype)


def _mlp(x: torch.Tensor, bp: Params, cfg: DecoderConfig) -> torch.Tensor:
    m = _layer_norm(x, bp["ln_2"], cfg.layer_norm_eps)
    return x + _dense(_gelu_new(_dense(m, bp["mlp"]["c_fc"])), bp["mlp"]["c_proj"])


def _logits(params: Params, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    x = _layer_norm(x, params["ln_f"], cfg.layer_norm_eps)
    return torch.matmul(x[:, 0, :], params["wte"]["embedding"].T)


def prefill(params: Params, image_features: torch.Tensor, bos_token: int,
            max_len: int, cfg: DecoderConfig,
            cache_dtype: Optional[torch.dtype] = None):
    """Start generation: write the image K/V to slot 0 and the BOS token's
    K/V to slot 1 of every layer. Returns (logits [B, vocab] at the BOS
    position, cache). The cache follows the parameter dtype unless
    `cache_dtype` is given (torch.int8 for the quantized cache)."""
    b = image_features.shape[0]
    wte = params["wte"]["embedding"]
    if cache_dtype is None:
        cache_dtype = wte.dtype
    img = feature_transform(params, image_features)[:, None, :]       # [B,1,D]
    cache = init_cache(b, max_len, cfg, cache_dtype, device=wte.device)

    ids = torch.full((b, 1), bos_token, dtype=torch.long, device=wte.device)
    pos = torch.zeros((b, 1), dtype=torch.long, device=wte.device)
    x = wte[ids] + _positions_embed(params, pos, cfg)
    bias = torch.zeros((1, 1, 1, 2), dtype=x.dtype, device=x.device)

    for i in range(cfg.num_layers):
        bp = params[f"h_{i}"]
        qkv = _dense(_layer_norm(x, bp["ln_1"], cfg.layer_norm_eps),
                     bp["attn"]["c_attn"])
        q, k_w, v_w = torch.split(qkv, cfg.hidden_dim, dim=-1)
        qh = _split_heads(q, cfg.num_heads, cfg.head_dim)            # [B,H,1,D]
        k_img = _split_heads(_dense(img, bp["attn"]["uk"]), cfg.num_heads, cfg.head_dim)
        v_img = _split_heads(_dense(img, bp["attn"]["uv"]), cfg.num_heads, cfg.head_dim)
        k01 = torch.cat([k_img, _split_heads(k_w, cfg.num_heads, cfg.head_dim)], dim=2)
        v01 = torch.cat([v_img, _split_heads(v_w, cfg.num_heads, cfg.head_dim)], dim=2)
        _cache_write(cache, i, slice(0, 2), k01, v01)
        # image + BOS both visible; attends over the unquantized values
        a = _attention(qh, k01, v01, bias)
        x = x + _dense(_merge_heads(a), bp["attn"]["c_proj"])
        x = _mlp(x, bp, cfg)

    return _logits(params, x, cfg), cache


def decode_step(params: Params, token: torch.Tensor, step: int,
                cache: Dict[str, torch.Tensor], cfg: DecoderConfig):
    """One generation step, updating `cache` in place.

    token [B]: the token generated at position `step` (0-based over
    generated tokens); its position id is step+1 and its cache slot step+2
    (slot 0 = image, slot 1 = BOS). Returns (logits [B, vocab], cache)."""
    b = token.shape[0]
    wte = params["wte"]["embedding"]
    pos = torch.full((b, 1), step + 1, dtype=torch.long, device=wte.device)
    x = wte[token[:, None]] + _positions_embed(params, pos, cfg)

    t_total = cache["k"].shape[3]
    slot = step + 2
    visible = torch.arange(t_total, device=x.device) <= slot
    bias = torch.where(visible, 0.0, MASK_VALUE).to(x.dtype)[None, None, None, :]

    for i in range(cfg.num_layers):
        bp = params[f"h_{i}"]
        qkv = _dense(_layer_norm(x, bp["ln_1"], cfg.layer_norm_eps),
                     bp["attn"]["c_attn"])
        q, k_w, v_w = torch.split(qkv, cfg.hidden_dim, dim=-1)
        qh = _split_heads(q, cfg.num_heads, cfg.head_dim)            # [B,H,1,D]
        _cache_write(cache, i, slice(slot, slot + 1),
                     _split_heads(k_w, cfg.num_heads, cfg.head_dim),
                     _split_heads(v_w, cfg.num_heads, cfg.head_dim))
        a = _attention(qh, _cache_read(cache, "k", i, x.dtype),
                       _cache_read(cache, "v", i, x.dtype), bias)
        x = x + _dense(_merge_heads(a), bp["attn"]["c_proj"])
        x = _mlp(x, bp, cfg)

    return _logits(params, x, cfg), cache

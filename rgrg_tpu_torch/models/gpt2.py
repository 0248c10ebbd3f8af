"""GPT-2 decoder with pseudo self-attention: the teacher-forced training
forward (forward_full) and the KV-cached generation path.

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
place: one slot per layer per step, no reallocation. Beam search moves it
once, after prefill, to per-layer head-leading buffers [H, B*K, 1+T, D]
(cache_to_beam_layers) that decode_step_beam updates in place and reads
through the ancestry table (ops/beam_attn.py, kernel K3 on the card).

forward_full runs whole sequences with dropout on the embeddings, the
attention weights and both residual branches (training), optionally
checkpointing each block (torch.utils.checkpoint restores the RNG state, so
a recomputed block draws the same dropout masks); with image_features=None
it is vanilla GPT-2 (no image slot).

quantize_decoder_weights turns each layer's four matmul kernels into
weight-only per-channel int8; _dense multiplies by them in either layout
(kernel K4, ops/dense_wint8.py, reads the "pallas" one on the card).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rgrg_tpu_torch.core.config import DecoderConfig
from rgrg_tpu_torch.ops.beam_attn import beam_attention
from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8

Params = Dict[str, Any]

MASK_VALUE = -1e4


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    """y = x @ kernel + bias with the kernel stored [in, out]. Takes both
    weight-only int8 layouts of quantize_decoder_weights:
      - "pallas" ({kernel_q, scale [1, N], bias}): kernel K4
        (ops/dense_wint8.py) reads the int8 weights and scales the f32 sum;
      - "xla" ({kernel int8, scale [N], bias}): a plain product in x's dtype
        over the dequantised weights, scaled and biased in f32 and cast
        back, rounding where the JAX package's XLA path does (in bf16 the
        product is rounded before the scale)."""
    if "kernel_q" in p:
        return dense_wint8(x, p["kernel_q"], p["scale"], p["bias"])
    k = p["kernel"]
    if k.dtype == torch.int8:
        y = torch.matmul(x, k.to(x.dtype))
        return (y.to(torch.float32) * p["scale"] + p["bias"].to(torch.float32)).to(y.dtype)
    return torch.matmul(x, k) + p["bias"]


def quantize_decoder_weights(params: Params, layout: str = "xla") -> Params:
    """Weight-only symmetric per-output-channel int8 of each layer's matmul
    kernels (attn c_attn/c_proj, mlp c_fc/c_proj); embeddings, layer norms,
    the uk/uv image adapters and the feature transform keep their dtype.

    Per column, in f32: s = max(max|w| / 127, 1e-12) and
    q = clip(round_half_even(w / s), -127, 127). layout="xla" stores
    {kernel int8 [in, out], scale [out], bias}; layout="pallas" stores
    {kernel_q int8 [in, out], scale [1, out], bias}, the layout K4 consumes.
    Returns a new tree; `params` is not changed."""
    if layout not in ("xla", "pallas"):
        raise ValueError(f"unknown layout {layout!r}")
    out = dict(params)
    for name, block in params.items():
        if not name.startswith("h_"):
            continue
        bp = dict(block)
        for grp_name, names in (("attn", ("c_attn", "c_proj")),
                                ("mlp", ("c_fc", "c_proj"))):
            grp = dict(bp[grp_name])
            for kn in names:
                w = grp[kn]["kernel"].to(torch.float32)
                s = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
                q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
                if layout == "pallas":
                    grp[kn] = {"kernel_q": q, "scale": s[None, :], "bias": grp[kn]["bias"]}
                else:
                    grp[kn] = {"kernel": q, "scale": s, "bias": grp[kn]["bias"]}
            bp[grp_name] = grp
        out[name] = bp
    return out


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


def _attn_scale(head_dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(D) evaluated in the query's dtype, as the reference does."""
    return torch.tensor(float(head_dim), dtype=dtype).sqrt().reciprocal().item()


def _dropout(x: torch.Tensor, rate: float,
             rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Training dropout (kept entries scaled by 1/(1-rate)); rate 0 is the
    identity and draws nothing. rows=(lo, total): `x` holds rows lo.. of a
    batch of `total` rows (one rank's share under a data-parallel mesh;
    default the whole batch): the mask is drawn at the whole batch's shape
    and cut to them."""
    if rate <= 0:
        return x
    lo, total = rows if rows is not None else (0, x.shape[0])
    keep = torch.rand((total,) + tuple(x.shape[1:]), device=x.device)[lo:lo + x.shape[0]]
    return torch.where(keep >= rate, x / (1.0 - rate), torch.zeros_like(x))


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor, dropout_rate: float = 0.0,
               rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """q [B,H,S,D] x k/v [B,H,T,D] with additive bias [.., S, T] (0 or -1e4);
    dropout_rate > 0 drops attention weights after the softmax."""
    w = torch.einsum("bhsd,bhtd->bhst", q, k) * _attn_scale(v.shape[-1], q.dtype)
    w = torch.softmax(w + bias, dim=-1).to(v.dtype)
    w = _dropout(w, dropout_rate, rows)
    return torch.einsum("bhst,bhtd->bhsd", w, v)


def _positions_embed(params: Params, position_ids: torch.Tensor,
                     cfg: DecoderConfig) -> torch.Tensor:
    table = params["wte" if cfg.positions_from_wte else "wpe"]["embedding"]
    return table[position_ids]


def forward_full(params: Params, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor, image_features: Optional[torch.Tensor],
                 cfg: DecoderConfig, dropout: bool = False,
                 remat: bool = False,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Teacher-forced forward over whole sequences: input_ids /
    attention_mask [B, S], image_features [B, F] raw region features (the
    feature-space transform runs here; cast to the parameters' dtype) or
    None for vanilla GPT-2. Returns lm logits [B, S, vocab].

    dropout=True applies cfg's embd / attn / resid dropout rates from the
    device's default RNG; remat=True checkpoints each block, so only its
    input is kept for backward. rows=(lo, total): the batch is rows lo.. of
    `total` (a rank's share of a data-parallel batch), whose dropout masks
    are cut from masks drawn for all `total` rows (`_dropout`)."""
    b, s = input_ids.shape
    wte = params["wte"]["embedding"]
    dev = wte.device
    img = None
    if image_features is not None:
        img = feature_transform(params, image_features.to(wte.dtype))[:, None, :]

    x = wte[input_ids] + _positions_embed(
        params, torch.arange(s, device=dev)[None, :], cfg)
    if dropout:
        x = _dropout(x, cfg.embd_dropout, rows)

    # bias [B, 1, S, (1+)S]: causal (the image column always visible) + padding
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    pad = attention_mask
    if img is not None:
        causal = torch.cat([torch.ones(s, 1, dtype=torch.bool, device=dev), causal], dim=1)
        pad = torch.cat([torch.ones(b, 1, dtype=attention_mask.dtype, device=dev),
                         attention_mask], dim=1)
    bias = torch.where(causal, 0.0, MASK_VALUE).to(x.dtype)[None, None]
    bias = bias + (1.0 - pad[:, None, None, :].to(x.dtype)) * MASK_VALUE
    attn_rate = cfg.attn_dropout if dropout else 0.0
    resid_rate = cfg.resid_dropout if dropout else 0.0
    h, d = cfg.num_heads, cfg.head_dim

    def block(x: torch.Tensor, bp: Params) -> torch.Tensor:
        qkv = _dense(_layer_norm(x, bp["ln_1"], cfg.layer_norm_eps), bp["attn"]["c_attn"])
        q, k, v = torch.split(qkv, cfg.hidden_dim, dim=-1)
        if img is not None:
            k = torch.cat([_dense(img, bp["attn"]["uk"]), k], dim=1)   # [B, 1+S, D]
            v = torch.cat([_dense(img, bp["attn"]["uv"]), v], dim=1)
        a = _attention(_split_heads(q, h, d), _split_heads(k, h, d),
                       _split_heads(v, h, d), bias, attn_rate, rows)
        x = x + _dropout(_dense(_merge_heads(a), bp["attn"]["c_proj"]), resid_rate, rows)
        m = _layer_norm(x, bp["ln_2"], cfg.layer_norm_eps)
        m = _dense(_gelu_new(_dense(m, bp["mlp"]["c_fc"])), bp["mlp"]["c_proj"])
        return x + _dropout(m, resid_rate, rows)

    for i in range(cfg.num_layers):
        if remat:
            x = checkpoint(block, x, params[f"h_{i}"], use_reentrant=False)
        else:
            x = block(x, params[f"h_{i}"])
    x = _layer_norm(x, params["ln_f"], cfg.layer_norm_eps)
    return torch.matmul(x, wte.T)


def language_model_loss(params: Params, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor,
                        image_features: Optional[torch.Tensor],
                        cfg: DecoderConfig) -> torch.Tensor:
    """Shift-by-one CE with padding positions ignored, averaged over the
    valid targets."""
    logits = forward_full(params, input_ids, attention_mask, image_features, cfg)
    logp = torch.log_softmax(logits[:, :-1, :].to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, input_ids[:, 1:, None].to(torch.int64))[..., 0]
    valid = attention_mask[:, 1:].to(torch.bool)
    nll = torch.where(valid, nll, 0.0)
    return torch.sum(nll) / torch.clamp(valid.sum(), min=1)


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


def prefill(params: Params, image_features: Optional[torch.Tensor], bos_token: int,
            max_len: int, cfg: DecoderConfig,
            cache_dtype: Optional[torch.dtype] = None, batch: Optional[int] = None):
    """Start generation: write the image K/V to slot 0 and the BOS token's
    K/V to slot 1 of every layer. Returns (logits [B, vocab] at the BOS
    position, cache). The cache follows the parameter dtype unless
    `cache_dtype` is given (torch.int8 for the quantized cache).

    image_features=None runs vanilla GPT-2 over `batch` rows: slot 0 stays
    zero and gets no weight, here and in the decode steps (no_image=True)."""
    with_image = image_features is not None
    b = image_features.shape[0] if with_image else batch
    if b is None:
        raise ValueError("prefill without image features needs `batch`")
    wte = params["wte"]["embedding"]
    if cache_dtype is None:
        cache_dtype = wte.dtype
    if with_image:
        img = feature_transform(params, image_features)[:, None, :]   # [B,1,D]
    cache = init_cache(b, max_len, cfg, cache_dtype, device=wte.device)

    ids = torch.full((b, 1), bos_token, dtype=torch.long, device=wte.device)
    pos = torch.zeros((b, 1), dtype=torch.long, device=wte.device)
    x = wte[ids] + _positions_embed(params, pos, cfg)
    # image + BOS both visible, or BOS alone
    bias = torch.tensor([[[[0.0 if with_image else MASK_VALUE, 0.0]]]],
                        dtype=x.dtype, device=x.device)

    for i in range(cfg.num_layers):
        bp = params[f"h_{i}"]
        qkv = _dense(_layer_norm(x, bp["ln_1"], cfg.layer_norm_eps),
                     bp["attn"]["c_attn"])
        q, k_w, v_w = torch.split(qkv, cfg.hidden_dim, dim=-1)
        qh = _split_heads(q, cfg.num_heads, cfg.head_dim)            # [B,H,1,D]
        kh = _split_heads(k_w, cfg.num_heads, cfg.head_dim)
        vh = _split_heads(v_w, cfg.num_heads, cfg.head_dim)
        if with_image:
            k_img = _split_heads(_dense(img, bp["attn"]["uk"]), cfg.num_heads, cfg.head_dim)
            v_img = _split_heads(_dense(img, bp["attn"]["uv"]), cfg.num_heads, cfg.head_dim)
        else:
            k_img, v_img = torch.zeros_like(kh), torch.zeros_like(vh)
        k01 = torch.cat([k_img, kh], dim=2)
        v01 = torch.cat([v_img, vh], dim=2)
        _cache_write(cache, i, slice(0, 2), k01, v01)
        # attends over the unquantized values
        a = _attention(qh, k01, v01, bias)
        x = x + _dense(_merge_heads(a), bp["attn"]["c_proj"])
        x = _mlp(x, bp, cfg)

    return _logits(params, x, cfg), cache


def decode_step(params: Params, token: torch.Tensor, step: int,
                cache: Dict[str, torch.Tensor], cfg: DecoderConfig,
                no_image: bool = False):
    """One generation step, updating `cache` in place.

    token [B]: the token generated at position `step` (0-based over
    generated tokens); its position id is step+1 and its cache slot step+2
    (slot 0 = image, slot 1 = BOS). no_image: slot 0 gets no weight
    (vanilla GPT-2, after prefill without image features). Returns
    (logits [B, vocab], cache)."""
    b = token.shape[0]
    wte = params["wte"]["embedding"]
    pos = torch.full((b, 1), step + 1, dtype=torch.long, device=wte.device)
    x = wte[token[:, None]] + _positions_embed(params, pos, cfg)

    t_total = cache["k"].shape[3]
    slot = step + 2
    t_idx = torch.arange(t_total, device=x.device)
    visible = t_idx <= slot
    if no_image:
        visible = visible & (t_idx != 0)
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


def cache_to_beam_layers(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Prefill cache [L, B*K, H, T, *] -> per-layer head-leading buffers
    {"k_0": [H, B*K, T, *], ..., "v_23", and "k_scale_i"/"v_scale_i" for
    int8}, each contiguous (one copy, after prefill).

    The JAX package can also merge adjacent head pairs into the last dim
    (pack_pairs) to avoid the TPU's 128-lane padding of 64-wide rows; its
    outputs are identical either way, and a 64-dim bf16 row is already 128
    bytes on the card, so the port keeps the unpacked layout only."""
    return {f"{name}_{i}": c[i].transpose(0, 1).contiguous()
            for name, c in cache.items() for i in range(c.shape[0])}


def decode_step_beam(params: Params, token: torch.Tensor, step: int,
                     cache: Dict[str, torch.Tensor], ancestry: torch.Tensor,
                     cfg: DecoderConfig, no_image: bool = False):
    """One beam-search step with ancestry-masked attention, updating `cache`
    in place.

    token [B*K] (row b*K + k: beam k of item b), generated at position
    `step` (cache slot step+2); cache from cache_to_beam_layers; ancestry
    [B, K, T] int32: for each item, live beam and slot, the beam whose
    lane holds that slot's K/V. The cache is never reordered: beam
    reordering rewrites only the ancestry table, and every layer's
    attention reads the named rows (ops/beam_attn.beam_attention, kernel K3
    on the card). no_image: attend from slot 1 on (t0=1), so the zero
    image slot of a vanilla GPT-2 prefill is left out, not merely given a
    weight of exp(-1e4). Returns (logits [B*K, vocab], cache)."""
    bk = token.shape[0]
    wte = params["wte"]["embedding"]
    pos = torch.full((bk, 1), step + 1, dtype=torch.long, device=wte.device)
    x = wte[token[:, None]] + _positions_embed(params, pos, cfg)
    slot = step + 2
    h, d = cfg.num_heads, cfg.head_dim
    quantized = cache["k_0"].dtype == torch.int8
    scale = _attn_scale(d, x.dtype)

    for i in range(cfg.num_layers):
        bp = params[f"h_{i}"]
        qkv = _dense(_layer_norm(x, bp["ln_1"], cfg.layer_norm_eps),
                     bp["attn"]["c_attn"])
        q, k_w, v_w = torch.split(qkv, cfg.hidden_dim, dim=-1)
        kh = k_w.reshape(bk, h, d).transpose(0, 1)                   # [H,BK,D]
        vh = v_w.reshape(bk, h, d).transpose(0, 1)
        if quantized:
            for name, val in (("k", kh), ("v", vh)):
                qv, sv = _quantize_kv(val)
                cache[f"{name}_{i}"][:, :, slot] = qv
                cache[f"{name}_scale_{i}"][:, :, slot] = sv
        else:
            cache[f"k_{i}"][:, :, slot] = kh
            cache[f"v_{i}"][:, :, slot] = vh
        ctx = beam_attention(q.reshape(bk, h, d).contiguous(), cache[f"k_{i}"],
                             cache[f"v_{i}"], ancestry, slot, scale=scale,
                             t0=1 if no_image else 0, k_scale=cache.get(f"k_scale_{i}"),
                             v_scale=cache.get(f"v_scale_{i}"))       # [BK,H,D] f32
        x = x + _dense(ctx.to(x.dtype).reshape(bk, 1, h * d), bp["attn"]["c_proj"])
        x = _mlp(x, bp, cfg)

    return _logits(params, x, cfg), cache

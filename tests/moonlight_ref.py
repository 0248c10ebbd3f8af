"""Plain float32 reference of the Moonlight (DeepSeek-V3 block) decoder
with RGRG's image slot: the teacher-forced full forward, non-absorbed
(keys and values made per head from the latent), experts by a loop.

It imports only torch, nothing of the port or of JAX; it is the tests'
copy of `port_bench/reference/moonlight.py`'s decoder. Sizes come as a
dict of the published config's keys (`sizes`), weights as a flat dict of
the program's parameter paths ("h_0.attn.q", ...; `flatten`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def sizes(cfg) -> Dict:
    """The published keys of a MoonlightConfig."""
    return {"hidden_size": cfg.hidden_dim, "num_attention_heads": cfg.num_heads,
            "num_hidden_layers": cfg.num_layers, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "first_k_dense_replace": cfg.first_k_dense_replace,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "n_routed_experts": cfg.n_routed_experts,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "norm_topk_prob": cfg.norm_topk_prob, "rms_norm_eps": cfg.layer_norm_eps,
            "rope_theta": cfg.rope_theta}


def rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """Rotate-half RoPE of x [..., S, dr] at positions pos [S]."""
    dr = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dr, 2, dtype=torch.float32) / dr))
    ang = pos.float()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], -1)
    rot = torch.cat([-x[..., dr // 2:], x[..., :dr // 2]], -1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def swiglu(x, gate_up, down):
    h = x @ gate_up
    i = h.shape[-1] // 2
    return (F.silu(h[..., :i]) * h[..., i:]) @ down


def moe(m, w, p, d):
    """m [M, D] through layer prefix p's experts, one expert at a time."""
    s = torch.sigmoid(m @ w[p + "router"].T)
    k = d["num_experts_per_tok"]
    choice = torch.topk(s + w[p + "bias"], k, dim=-1).indices
    wt = torch.gather(s, 1, choice)
    if d["norm_topk_prob"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    wt = wt * d["routed_scaling_factor"]
    out = swiglu(m, w[p + "shared_gate_up"], w[p + "shared_down"])
    for e in range(w[p + "router"].shape[0]):
        rows, slot = torch.nonzero(choice == e, as_tuple=True)
        if rows.numel():
            out[rows] += wt[rows, slot, None] * swiglu(m[rows], w[p + "gate_up"][e],
                                                       w[p + "down"][e])
    return out


def decoder_logits(w: Dict[str, torch.Tensor], d: Dict, features: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Region features [N, F] and input ids [N, S] (BOS first) -> logits
    [N, S, V] f32: the logits at position s predict token s + 1. Slot 0
    holds the image's row, token s sits in slot s + 1 (its RoPE position)."""
    w = {k: v.float() for k, v in w.items()}
    n, s = tokens.shape
    h, dn, dr = d["num_attention_heads"], d["qk_nope_head_dim"], d["qk_rope_head_dim"]
    dv, r, eps = d["v_head_dim"], d["kv_lora_rank"], d["rms_norm_eps"]
    f = features.float()
    f = F.relu(f @ w["feature_transform.fc0.kernel"] + w["feature_transform.fc0.bias"])
    f = f @ w["feature_transform.fc1.kernel"] + w["feature_transform.fc1.bias"]
    x = w["wte.embedding"][tokens]
    pos = torch.arange(1, s + 1)
    visible = torch.ones(s, s + 1, dtype=torch.bool).tril(1)
    for i in range(d["num_hidden_layers"]):
        p = f"h_{i}."
        a = rms(x, w[p + "input_norm"], eps)
        q = (a @ w[p + "attn.q"]).view(n, s, h, dn + dr).transpose(1, 2)     # [N, H, S, .]
        q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, d["rope_theta"])], -1)
        kv = a @ w[p + "attn.kva"]
        img = f @ w[p + "attn.img"]
        c = torch.cat([rms(img[:, None, :r], w[p + "attn.kv_norm"], eps),
                       rms(kv[..., :r], w[p + "attn.kv_norm"], eps)], 1)       # [N, S+1, R]
        k_pe = torch.cat([img[:, None, r:], rope(kv[..., r:], pos, d["rope_theta"])], 1)
        kvb = (c @ w[p + "attn.kvb"]).view(n, s + 1, h, dn + dv).transpose(1, 2)
        key = torch.cat([kvb[..., :dn], k_pe[:, None].expand(n, h, s + 1, dr)], -1)
        score = (q @ key.transpose(-1, -2)) / math.sqrt(dn + dr)
        score = score.masked_fill(~visible, float("-inf"))
        o = torch.softmax(score, -1) @ kvb[..., dn:]                          # [N, H, S, dv]
        x = x + o.transpose(1, 2).reshape(n, s, h * dv) @ w[p + "attn.o"]
        m = rms(x, w[p + "post_norm"], eps)
        if i < d["first_k_dense_replace"]:
            x = x + swiglu(m, w[p + "mlp.gate_up"], w[p + "mlp.down"])
        else:
            x = x + moe(m.reshape(n * s, -1), w, p + "moe.", d).view(n, s, -1)
    return rms(x, w["norm"], eps) @ w["lm_head"]

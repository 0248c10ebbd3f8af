"""Plain reference of RGRG with the Moonlight-16B-A3B decoder: the
detector of `rgrg.py` and a teacher-forced DeepSeek-V3 decoder, written
from the published block (configs/rgrg-moonlight-serve-bf16.json says
where this repository's wiring departs from it).

It imports only torch and the reference it extends, nothing of the
program under test. The decoder is the full forward, non-absorbed: per
head, keys and values are made from the latent (c W_uk, c W_uv) and the
key's RoPE part is shared by the heads; the experts run one at a time
over the rows routed to them. The image's row sits in slot 0, token s in
slot s + 1, its RoPE position.

The seeded weights stay in their bfloat16 as made; each tensor is cast to
float32 (or, for the control, rounded to float8 e4m3 per output channel)
as it is used and dropped after: 64 GB of float32 weights would not fit
beside anything. Every product's operands go through `_act` / `_weight`
as in `rgrg.py`: float32 proper (TF32 off), or the control's float8
operands with a bfloat16 product. RMSNorm, RoPE, the router's sigmoid and
the softmax run in float32 on both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import rgrg


class Reference(rgrg.Reference):
    def _mat(self, name: str, expert: int = None, in_axis: int = 0) -> torch.Tensor:
        """A decoder matrix (one expert's of a stacked one), in the
        reference's precision (the control's scaled per output channel),
        never kept."""
        w = self.w["decoder." + name]
        if expert is not None:
            w = w[expert]
        return rgrg.fp8(w.float(), [in_axis]) if self.lowp else w.float()

    def _vec(self, name: str) -> torch.Tensor:
        return self.w["decoder." + name].float()

    def _mm(self, x: torch.Tensor, name: str, expert: int = None) -> torch.Tensor:
        return torch.matmul(self._act(x), self._mat(name, expert)).float()

    def _rms(self, x: torch.Tensor, name: str) -> torch.Tensor:
        eps = self.cfg["decoder"]["rms_norm_eps"]
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * self._vec(name)

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        dr = x.shape[-1]
        theta = float(self.cfg["decoder"]["rope_theta"])
        inv = 1.0 / (theta ** (torch.arange(0, dr, 2, dtype=torch.float32, device=x.device) / dr))
        ang = pos.float()[:, None] * inv[None, :]
        ang = torch.cat([ang, ang], -1)
        rot = torch.cat([-x[..., dr // 2:], x[..., :dr // 2]], -1)
        return x * torch.cos(ang) + rot * torch.sin(ang)

    def _swiglu(self, x: torch.Tensor, gate_up: str, down: str, expert: int = None):
        h = self._mm(x, gate_up, expert)
        i = h.shape[-1] // 2
        return self._mm(F.silu(h[..., :i]) * h[..., i:], down, expert)

    def _moe(self, m: torch.Tensor, p: str) -> torch.Tensor:
        """m [M, D] through layer prefix p's routed and shared experts."""
        d = self.cfg["decoder"]
        k = d["num_experts_per_tok"]
        router = self._mat(p + "router", in_axis=1)
        s = torch.sigmoid(torch.matmul(self._act(m), router.T).float())
        choice = torch.topk(s + self._vec(p + "bias"), k, dim=-1).indices
        wt = torch.gather(s, 1, choice)
        if d["norm_topk_prob"]:
            wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
        wt = wt * d["routed_scaling_factor"]
        out = self._swiglu(m, p + "shared_gate_up", p + "shared_down")
        for e in range(d["n_routed_experts"]):
            rows, slot = torch.nonzero(choice == e, as_tuple=True)
            if rows.numel():
                out[rows] += wt[rows, slot, None] * self._swiglu(
                    m[rows], p + "gate_up", p + "down", e)
        return out

    def decoder_logits(self, features: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Region features [N, F] and input ids [N, S] (BOS first) ->
        logits [N, S, V] f32, the logits at position s predicting token
        s + 1."""
        d = self.cfg["decoder"]
        n, s = tokens.shape
        h, dn, dr = d["num_attention_heads"], d["qk_nope_head_dim"], d["qk_rope_head_dim"]
        dv, r = d["v_head_dim"], d["kv_lora_rank"]
        dev = tokens.device
        f = F.relu(self._mm(features, "feature_transform.fc0.kernel")
                   + self._vec("feature_transform.fc0.bias"))
        f = self._mm(f, "feature_transform.fc1.kernel") + self._vec("feature_transform.fc1.bias")
        x = self.w["decoder.wte.embedding"][tokens].float()
        pos = torch.arange(1, s + 1, device=dev)
        visible = torch.ones(s, s + 1, dtype=torch.bool, device=dev).tril(1)
        for i in range(d["num_hidden_layers"]):
            p = f"h_{i}."
            a = self._rms(x, p + "input_norm")
            q = self._mm(a, p + "attn.q").view(n, s, h, dn + dr).transpose(1, 2)
            q = torch.cat([q[..., :dn], self._rope(q[..., dn:], pos)], -1)
            kv = self._mm(a, p + "attn.kva")
            img = self._mm(f, p + "attn.img")
            c = torch.cat([self._rms(img[:, None, :r], p + "attn.kv_norm"),
                           self._rms(kv[..., :r], p + "attn.kv_norm")], 1)     # [N, S+1, R]
            k_pe = torch.cat([img[:, None, r:], self._rope(kv[..., r:], pos)], 1)
            kvb = self._mm(c, p + "attn.kvb").view(n, s + 1, h, dn + dv).transpose(1, 2)
            key = torch.cat([kvb[..., :dn], k_pe[:, None].expand(n, h, s + 1, dr)], -1)
            score = torch.matmul(self._act(q), self._act(key).transpose(-1, -2)).float()
            score = (score / math.sqrt(dn + dr)).masked_fill(~visible, float("-inf"))
            o = torch.matmul(self._act(torch.softmax(score, -1)),
                             self._act(kvb[..., dn:])).float()                # [N, H, S, dv]
            x = x + self._mm(o.transpose(1, 2).reshape(n, s, h * dv), p + "attn.o")
            m = self._rms(x, p + "post_norm")
            if i < d["first_k_dense_replace"]:
                x = x + self._swiglu(m, p + "mlp.gate_up", p + "mlp.down")
            else:
                x = x + self._moe(m.reshape(n * s, -1), p + "moe.").view(n, s, -1)
        return self._mm(self._rms(x, "norm"), "lm_head")

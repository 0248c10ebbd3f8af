"""Closed-loop batch serving (`serve_pipelined`) with the Moonlight
decoder: the same backlog, server and judge, with only the decoder's
weights, the program's parameters and the reference replaced.

- weights: the detector's as `weights.py` makes them, then the decoder's
  (`decoder_layout`: N(0, 0.02) matrices and correction biases, unit norm
  scales, zero feature-transform biases) in one draw in the decoder's
  dtype. The program holds these tensors themselves, not copies: the
  decoder is 32 GB in bfloat16, and a copy would not fit beside it.
- the program: the config file's `decoder` as a MoonlightConfig.
- the reference: `reference/moonlight.py`, after the program is freed;
  the judge `reference/judge_moe.py` (judge_serve's numbers and the mean
  token gap, which separates bfloat16 from the float8 control where the
  worst position cannot: see there).

The window and the traced slice also read the program's device counters
(`moe.expert_rows`, `moe.expert_steps`) before and after, outside any
step, which the per-layer metrics of the expert layers read.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.program import program_config, program_params
from port_bench.run import BENCH, load_module
from port_bench.vocab import tokenizer
from port_bench.weights import Spec, _fill, calibrate_heads, detector_layout, make_xrays

base = load_module(os.path.join(BENCH, "drivers", "serve_pipelined.py"))


def decoder_layout(cfg: Dict) -> List[Spec]:
    """The decoder's weights under the program's parameter paths
    (models/moonlight.py), kernels [in, out]."""
    d = cfg["decoder"]
    hid, heads, r = d["hidden_size"], d["num_attention_heads"], d["kv_lora_rank"]
    dn, dr, dv = d["qk_nope_head_dim"], d["qk_rope_head_dim"], d["v_head_dim"]
    e, im = d["n_routed_experts"], d["moe_intermediate_size"]
    std = 0.02

    def mat(name, *shape):
        return [(name, tuple(shape), "normal", std)]

    def ones(name, n):
        return [(name, (n,), "ones", 0.0)]

    out = mat("decoder.wte.embedding", d["vocab_size"], hid)
    out += mat("decoder.feature_transform.fc0.kernel", cfg["region_feature_dim"], hid)
    out += [("decoder.feature_transform.fc0.bias", (hid,), "zeros", 0.0)]
    out += mat("decoder.feature_transform.fc1.kernel", hid, hid)
    out += [("decoder.feature_transform.fc1.bias", (hid,), "zeros", 0.0)]
    out += ones("decoder.norm", hid) + mat("decoder.lm_head", hid, d["vocab_size"])
    for i in range(d["num_hidden_layers"]):
        p = f"decoder.h_{i}."
        out += ones(p + "input_norm", hid) + ones(p + "post_norm", hid)
        out += mat(p + "attn.q", hid, heads * (dn + dr)) + mat(p + "attn.kva", hid, r + dr)
        out += ones(p + "attn.kv_norm", r) + mat(p + "attn.kvb", r, heads * (dn + dv))
        out += mat(p + "attn.o", heads * dv, hid) + mat(p + "attn.img", hid, r + dr)
        if i < d["first_k_dense_replace"]:
            out += mat(p + "mlp.gate_up", hid, 2 * d["intermediate_size"])
            out += mat(p + "mlp.down", d["intermediate_size"], hid)
        else:
            shared = im * d["n_shared_experts"]
            out += mat(p + "moe.router", e, hid) + mat(p + "moe.bias", e)
            out += mat(p + "moe.gate_up", e, hid, 2 * im) + mat(p + "moe.down", e, im, hid)
            out += mat(p + "moe.shared_gate_up", hid, 2 * shared)
            out += mat(p + "moe.shared_down", shared, hid)
    return out


def make_weights(cfg: Dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every weight of the configuration from `seed`, on `device`: the
    detector's draw first, as `weights.make_weights` makes it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = _fill(detector_layout(cfg), torch.float32, gen, device)
    w.update(_fill(decoder_layout(cfg), getattr(torch, cfg["decoder_dtype"]), gen, device))
    return w


def moonlight_config(cfg: Dict):
    """The program's ModelConfig: the detector's and classifier's as
    program.program_config reads them, the decoder a MoonlightConfig."""
    from rgrg_tpu_torch.core.config import MoonlightConfig
    d = cfg["decoder"]
    if d["kind"] != "moonlight" or d["scoring_func"] != "sigmoid" or \
            d["topk_method"] != "noaux_tc" or d["n_group"] != 1 or d["q_lora_rank"] is not None:
        raise ValueError("the program's Moonlight decoder runs the noaux_tc sigmoid router "
                         "over one group, without query compression")
    gpt2_keys = dict(vocab_size=d["vocab_size"], hidden_dim=d["hidden_size"],
                     num_heads=d["num_attention_heads"], num_layers=d["num_hidden_layers"],
                     max_positions=cfg["max_position_embeddings"],
                     bos_token_id=d["bos_token_id"], eos_token_id=d["eos_token_id"],
                     pad_token_id=d["pad_token_id"], positions_from_wte=False,
                     layer_norm_eps=d["rms_norm_eps"])
    mcfg = program_config(dict(cfg, decoder=gpt2_keys))
    dec = MoonlightConfig(
        image_feature_dim=cfg["region_feature_dim"], kv_lora_rank=d["kv_lora_rank"],
        qk_nope_head_dim=d["qk_nope_head_dim"], qk_rope_head_dim=d["qk_rope_head_dim"],
        v_head_dim=d["v_head_dim"], intermediate_size=d["intermediate_size"],
        moe_intermediate_size=d["moe_intermediate_size"],
        n_routed_experts=d["n_routed_experts"], n_shared_experts=d["n_shared_experts"],
        num_experts_per_tok=d["num_experts_per_tok"],
        first_k_dense_replace=d["first_k_dense_replace"],
        routed_scaling_factor=d["routed_scaling_factor"], norm_topk_prob=d["norm_topk_prob"],
        rope_theta=float(d["rope_theta"]), **gpt2_keys)
    return dataclasses.replace(mcfg, decoder=dec)


def moonlight_params(w: Dict[str, torch.Tensor], mcfg, device: torch.device) -> Dict:
    """The program's params: its own detector module, and the decoder's
    tree over the weight tensors themselves."""
    out = program_params({k: v for k, v in w.items() if not k.startswith("decoder.")},
                         mcfg, device)
    for name, t in w.items():
        if name.startswith("decoder."):
            node = out["decoder"]
            *path, leaf = name.split(".")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = t
    return out


def device_counters() -> Dict[str, np.ndarray]:
    from rgrg_tpu_torch.utils.logging import counters
    return {k: np.asarray(v) for k, v in counters(device=True).items()
            if k.startswith("moe.")}


def counters_since(before: Dict[str, np.ndarray]) -> Dict[str, list]:
    after = device_counters()
    return {k: (v - before.get(k, 0)).tolist() for k, v in after.items()}


class Driver(base.Driver):
    def setup(self) -> None:
        # first, so that a program without this decoder fails at once
        from rgrg_tpu_torch.core.config import MoonlightConfig  # noqa: F401
        from rgrg_tpu_torch.inference import ReportGenerator
        from rgrg_tpu_torch.serving import generate_reports_pipelined
        if self.device.type == "cuda":
            from rgrg_tpu_torch.ops import kernels
            kernels.build()
        cfg, tr = self.cfg, self.traffic
        mcfg = moonlight_config(cfg)
        w = make_weights(cfg, self.seed, self.device)
        pool = make_xrays(tr["pool_images"], tuple(tr["image_shape"]), self.seed, self.device)
        t0 = time.perf_counter()
        self.biases = calibrate_heads(w, cfg, pool, tr["select_share"])
        self.readout_s = time.perf_counter() - t0
        self.pool = list(pool.cpu().numpy())
        del pool
        params = moonlight_params(w, mcfg, self.device)
        del w
        self.gen = ReportGenerator(params, tokenizer(cfg), cfg=mcfg, similarity_fn=None)
        del params
        self.spans = base.Spans(self.gen.model)
        self.gen.model = self.spans
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        n = tr["pool_images"] * tr["pool_cycles"]
        self.order = [i % tr["pool_images"] for i in range(n)]
        self.stream = generate_reports_pipelined(
            self.gen, [self.pool[i] for i in self.order], batch_size=tr["batch_size"],
            num_beams=tr["num_beams"], max_length=tr["max_length"],
            early_stopping=tr["early_stopping"], kv_cache_dtype=cfg["kv_cache_dtype"],
            device_resize=tr["device_resize"], weights_int8=cfg["weights_int8"])
        self.next_image = 0
        for _ in range(tr["warmup_batches"]):
            self._next()
        self._sync()

    def window(self, seconds: float) -> Dict:
        before = device_counters()
        win = super().window(seconds)
        win["counters"].update(counters_since(before))
        return win

    def trace(self) -> Dict:
        self._sync()
        before = device_counters()
        out = super().trace()
        out["counters"] = counters_since(before)
        return out

    def finish(self) -> None:
        """As serve_pipelined's, and the beam step's graph sets go too: each
        holds the 32 GB of weights it was captured over, which the
        reference's own copy, or the next seed's program, must not meet."""
        from rgrg_tpu_torch.decode import beam
        super().finish()
        beam.GRAPH_SETS.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> Dict:
        """As serve_pipelined's, with the Moonlight reference and judge_moe."""
        from port_bench.reference.judge_moe import judge
        from port_bench.reference.moonlight import Reference
        outs = self.outputs()
        imgs = sorted(outs)
        w = make_weights(self.cfg, self.seed, self.device)
        for name, b in self.biases.items():
            w[name].copy_(b)
        ref = Reference(self.cfg, w)
        ctrl = Reference(self.cfg, w, precision="fp8") if control else None
        pixels = torch.from_numpy(np.stack([self.pool[i] for i in imgs])).to(self.device)
        with torch.no_grad():
            return judge(ref, pixels, [outs[i] for i in imgs], self.traffic["num_beams"],
                         control=ctrl)

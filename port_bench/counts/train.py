"""Floating-point operations of one stage-3 training mini-step, counted
from the shapes (2 per multiply-add), for the training cells' whole-step
share of peak.

Forward and backward of the backbone, the RPN head and the box head
(x3: forward, input gradient, weight gradient); RoIAlign (kernel K2)
forward and backward as the taps they need, 2 x 2 samples of 4 cells a
bin and channel each way, not as the dense product the program runs for
its backward; the classifiers; the decoder over the LM budget's rows at
the batch's mean sentence length, causal attention over the image slot
and the tokens before, forward and its activation gradient (x2: GPT-2's
weights are frozen, the image projections' gradients are a small part);
the LM head x2.
"""

from __future__ import annotations

from typing import Dict

from port_bench.counts.serve import resnet_flops


def step_flops(cfg: Dict, mean_tokens: float) -> Dict[str, float]:
    t, d = cfg["train"], cfg["decoder"]
    b, s = t["batch_size"], t["roi_batch_per_image"]
    c = cfg["backbone_channels"]
    g = cfg["image_size"] // cfg["backbone_stride"]
    a = len(cfg["anchor_sizes"]) * len(cfg["anchor_aspect_ratios"])
    p, smp = cfg["roi_output_size"], cfg["sampling_ratio"]
    rep, r, f = cfg["representation_size"], cfg["num_regions"], cfg["region_feature_dim"]
    hidden = [f] + list(cfg["classifier_hidden"]) + [1]
    mlp = sum(hidden[i] * hidden[i + 1] for i in range(len(hidden) - 1))
    hid = d["hidden_dim"]
    rows, n = t["lm_budget"], mean_tokens
    per_token = d["num_layers"] * 2 * hid * (3 * hid + hid + 8 * hid)
    attention = d["num_layers"] * 4 * hid * rows * (n * (n + 1) / 2 + n)   # slots t + 2 at t
    parts = {
        "backbone": 3 * b * resnet_flops(cfg),
        "rpn_head": 3 * 2.0 * b * g * g * c * (9 * c + 5 * a),
        "k2_roi_align": 2 * 2.0 * b * s * p * p * c * smp * smp * 4,
        "box_head": 3 * 2.0 * b * s * (p * p * c * rep + rep * rep + rep * 5 * (r + 1)),
        "regions": 3 * 2.0 * b * r * (c * f + 2 * mlp),
        "decoder": 2 * (rows * n * per_token + attention),
        "lm_head": 2 * 2.0 * rows * n * hid * d["vocab_size"],
    }
    parts["total"] = sum(parts.values())
    return parts

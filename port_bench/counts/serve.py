"""Floating-point operations a served batch needs, counted from the shapes
(2 per multiply-add), for the serving cells' whole-step share of peak.

Counted as these inputs need them: the device resize of each image, the
detector over its proposals, and per decoded row its prefill once and one
decode step per generated token after the first, every step over the
cache as long as it is at that step; beam search counts its K lanes a
step. Rows the row budget pads, and steps of rows already finished, are
not counted: the program may spend them, the inputs do not need them.
"""

from __future__ import annotations

from typing import Dict, Iterable


def resnet_flops(cfg: Dict) -> float:
    s = cfg["image_size"] // 2                 # conv1, stride 2
    total = 2.0 * 1 * 64 * 49 * s * s
    s //= 2                                    # max pool
    cin, width = 64, 64
    for stage, blocks in enumerate(cfg["backbone_stages"]):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            out = s // stride
            total += 2.0 * cin * width * s * s                 # 1x1 reduce
            total += 2.0 * width * width * 9 * out * out       # 3x3 (stride here)
            total += 2.0 * width * 4 * width * out * out       # 1x1 expand
            if b == 0:
                total += 2.0 * cin * 4 * width * out * out     # downsample
            cin, s = 4 * width, out
        width *= 2
    return total


def detector_flops(cfg: Dict, image_shape) -> float:
    """One image of `image_shape` (H, W) through resize and detector."""
    h, w = image_shape
    size = cfg["image_size"]
    c = cfg["backbone_channels"]
    g = size // cfg["backbone_stride"]
    a = len(cfg["anchor_sizes"]) * len(cfg["anchor_aspect_ratios"])
    k = cfg["rpn_pre_nms_top_n_test"]
    p, s = cfg["roi_output_size"], cfg["sampling_ratio"]
    rep, r, f = cfg["representation_size"], cfg["num_regions"], cfg["region_feature_dim"]
    total = 2.0 * size * h * w + 2.0 * size * w * size           # resize: two products
    total += resnet_flops(cfg)
    total += 2.0 * c * c * 9 * g * g + 2.0 * c * 5 * a * g * g   # RPN conv + both 1x1
    total += k * 2.0 * 4 * s * s * p * p * c                     # RoIAlign: 4 taps a sample
    total += k * 2.0 * (p * p * c * rep + rep * rep + rep * 5 * (r + 1))   # box head
    hidden = [f] + list(cfg["classifier_hidden"]) + [1]
    mlp = sum(hidden[i] * hidden[i + 1] for i in range(len(hidden) - 1))
    total += r * 2.0 * (c * f + 2 * mlp)                         # dim reduction, classifiers
    return total


def token_flops(cfg: Dict, slots: int) -> float:
    """One token of one lane through the decoder, attending `slots` cache
    slots, and the LM head."""
    d = cfg["decoder"]
    hid = d["hidden_dim"]
    layer = 2.0 * hid * (3 * hid + hid + 8 * hid) + 4.0 * slots * hid
    return d["num_layers"] * layer + 2.0 * hid * d["vocab_size"]


def row_flops(cfg: Dict, generated: int, beams: int) -> float:
    """A decoded row that generated `generated` tokens: the prefill (image
    projections and BOS) once, then one step per token after the first
    on each of `beams` lanes; the step for token i (i >= 2) attends i + 1
    slots (image, BOS, tokens)."""
    d = cfg["decoder"]
    hid = d["hidden_dim"]
    prefill = 2.0 * (cfg["region_feature_dim"] * hid + hid * hid)           # feature transform
    prefill += d["num_layers"] * 2.0 * 2 * hid * hid + token_flops(cfg, 2)  # uk/uv, BOS
    steps = sum(token_flops(cfg, i + 1) for i in range(2, generated + 1))
    return prefill + max(beams, 1) * steps


def batch_flops(cfg: Dict, traffic: Dict, work: Dict) -> float:
    """work: {"images": n, "row_tokens": [served words of each decoded
    row]}. A row that served fewer words than max_length - 1 also
    generated its EOS."""
    cap = traffic["max_length"] - 1
    total = work["images"] * detector_flops(cfg, traffic["image_shape"])
    for n in work["row_tokens"]:
        total += row_flops(cfg, min(n + 1, cap), traffic["num_beams"])
    return total


def window_flops(cfg: Dict, traffic: Dict, works: Iterable[Dict]) -> float:
    return sum(batch_flops(cfg, traffic, w) for w in works)

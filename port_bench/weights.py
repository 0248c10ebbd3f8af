"""Seeded weights and inputs of a configuration, made on the device.

The weights are keyed by their checkpoint names: the program's detector
state-dict names and its decoder tree's paths under `decoder.`. Both the
program (through the driver) and the plain reference read these tensors;
neither makes its own. Matrices are drawn in one `torch.randn` call per
dtype from a generator on the device and scaled per tensor (lecun-normal
for the detector's convs and dense layers, N(0, 0.02) for GPT-2's),
biases are zero, norms have unit scale, BatchNorm has identity
statistics. The detector is made in float32 and the decoder in the dtype
it is served in.

`calibrate_heads` then sets two biases from the reference over the image
pool, so that every seed gives the server the same work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, float]   # name, shape, kind, std


def _conv(name: str, cout: int, cin: int, k: int, bias: bool) -> List[Spec]:
    out = [(name + ".weight", (cout, cin, k, k), "normal", 1.0 / math.sqrt(cin * k * k))]
    if bias:
        out.append((name + ".bias", (cout,), "zeros", 0.0))
    return out


def _bn(name: str, c: int) -> List[Spec]:
    return [(name + ".weight", (c,), "ones", 0.0), (name + ".bias", (c,), "zeros", 0.0),
            (name + ".running_mean", (c,), "zeros", 0.0),
            (name + ".running_var", (c,), "ones", 0.0)]


def _linear(name: str, cout: int, cin: int) -> List[Spec]:
    return [(name + ".weight", (cout, cin), "normal", 1.0 / math.sqrt(cin)),
            (name + ".bias", (cout,), "zeros", 0.0)]


def detector_layout(cfg: Dict) -> List[Spec]:
    c5 = cfg["backbone_channels"]
    out = _conv("backbone.conv1", 64, 1, 7, False) + _bn("backbone.bn1", 64)
    cin, width = 64, 64
    for s, blocks in enumerate(cfg["backbone_stages"]):
        for b in range(blocks):
            p = f"backbone.layer{s + 1}_{b}."
            out += _conv(p + "conv1", width, cin, 1, False) + _bn(p + "bn1", width)
            out += _conv(p + "conv2", width, width, 3, False) + _bn(p + "bn2", width)
            out += _conv(p + "conv3", width * 4, width, 1, False) + _bn(p + "bn3", width * 4)
            if b == 0:
                out += _conv(p + "downsample_conv", width * 4, cin, 1, False)
                out += _bn(p + "downsample_bn", width * 4)
            cin = width * 4
        width *= 2
    a = len(cfg["anchor_sizes"]) * len(cfg["anchor_aspect_ratios"])
    # Faster R-CNN's own conventions for its heads: the RPN's convs
    # N(0, 0.01) (torchvision's RPNHead), both box regressors N(0, 0.001)
    # (Fast R-CNN's bbox_pred), so that deltas are of a trained detector's
    # size; lecun-normal regressors give deltas whose exp() makes boxes
    # thousands of pixels wide before they are clipped
    out += [(n, s, k, 0.01 if k == "normal" else std) for n, s, k, std in
            _conv("rpn_head.conv", c5, c5, 3, True) + _conv("rpn_head.cls_logits", a, c5, 1, True)]
    out += [(n, s, k, 0.001 if k == "normal" else std) for n, s, k, std in
            _conv("rpn_head.bbox_pred", 4 * a, c5, 1, True)]
    p, rep, r = cfg["roi_output_size"], cfg["representation_size"], cfg["num_regions"]
    out += [("box_head.fc6.kernel", (p * p * c5, rep), "normal", 1.0 / math.sqrt(p * p * c5)),
            ("box_head.fc6.bias", (rep,), "zeros", 0.0)]
    out += _linear("box_head.fc7", rep, rep)
    out += _linear("box_predictor.cls_score", r + 1, rep)
    out += [("box_predictor.bbox_pred.weight", (4 * (r + 1), rep), "normal", 0.001),
            ("box_predictor.bbox_pred.bias", (4 * (r + 1),), "zeros", 0.0)]
    f = cfg["region_feature_dim"]
    out += _linear("dim_reduction", f, c5)
    for head in ("selection_classifier", "abnormal_classifier"):
        dims = [f] + list(cfg["classifier_hidden"]) + [1]
        for i in range(len(dims) - 1):
            out += _linear(f"{head}.fc{i}", dims[i + 1], dims[i])
    return out


def decoder_layout(cfg: Dict) -> List[Spec]:
    d = cfg["decoder"]
    h, std = d["hidden_dim"], 0.02

    def dense(name, cin, cout):
        return [(name + ".kernel", (cin, cout), "normal", std), (name + ".bias", (cout,), "zeros", 0.0)]

    def ln(name):
        return [(name + ".scale", (h,), "ones", 0.0), (name + ".bias", (h,), "zeros", 0.0)]

    out = [("decoder.wte.embedding", (d["vocab_size"], h), "normal", std),
           ("decoder.wpe.embedding", (d["max_positions"], h), "normal", std)]
    out += ln("decoder.ln_f")
    out += dense("decoder.feature_transform.fc0", cfg["region_feature_dim"], h)
    out += dense("decoder.feature_transform.fc1", h, h)
    for i in range(d["num_layers"]):
        p = f"decoder.h_{i}."
        out += ln(p + "ln_1") + ln(p + "ln_2")
        out += dense(p + "attn.c_attn", h, 3 * h) + dense(p + "attn.c_proj", h, h)
        out += dense(p + "attn.uk", h, h) + dense(p + "attn.uv", h, h)
        out += dense(p + "mlp.c_fc", h, 4 * h) + dense(p + "mlp.c_proj", 4 * h, h)
    return out


def _fill(specs: List[Spec], dtype: torch.dtype, gen: torch.Generator,
          device: torch.device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(s) for _, s, kind, _ in specs if kind == "normal")
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, kind, std in specs:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif kind == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def make_weights(cfg: Dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every weight of the configuration from `seed`, on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = _fill(detector_layout(cfg), torch.float32, gen, device)
    w.update(_fill(decoder_layout(cfg), getattr(torch, cfg["decoder_dtype"]), gen, device))
    return w


def calibrate_heads(w: Dict[str, torch.Tensor], cfg: Dict, images_u8: torch.Tensor,
                    share: float, block: int = 16) -> Dict[str, torch.Tensor]:
    """Sets two biases in `w` from the float32 reference over the pool,
    so that the random detector behaves like a trained one in what sets
    the server's work: every region is found, and a `share` of all
    regions is selected on every seed.

    - `box_predictor.cls_score.bias` of the 29 region classes: minus each
      class's logit at the mean fc7 output of the first `block` images'
      kept proposals (ReLU features share a large common part, and
      without this a few classes win every proposal);
    - `selection_classifier.fc2.bias`: the selection threshold midway
      between the two top-1 logits that `share` falls between.

    Returns both biases (the reference of a run sets them again)."""
    from port_bench.reference.rgrg import Reference
    ref = Reference(cfg, w)
    with torch.no_grad():
        dets = ref.detect(images_u8[:block])
        mean_h = torch.cat([d["hidden"][d["keep"]] for d in dets]).mean(0)
        cls_w = w["box_predictor.cls_score.weight"]
        w["box_predictor.cls_score.bias"][1:] = -(cls_w[1:] @ mean_h)
        logits = []
        for at in range(0, images_u8.shape[0], block):
            for det in ref.detect(images_u8[at:at + block]):
                sel = det["selection"][det["top_idx"]]
                logits.append(torch.where(det["detected"], sel, float("-inf")))
    v = torch.sort(torch.cat(logits), descending=True).values
    k = max(1, min(int(round(share * v.numel())), v.numel() - 1))
    mid = 0.5 * (v[k - 1] + v[k]) if torch.isfinite(v[k]) else v[k - 1] - 1.0
    w["selection_classifier.fc2.bias"] += cfg["logit_threshold"] - mid
    return {k: w[k].clone() for k in ("box_predictor.cls_score.bias",
                                       "selection_classifier.fc2.bias")}


def make_xrays(count: int, shape: Tuple[int, int], seed: int,
               device: torch.device) -> torch.Tensor:
    """[count, H, W] uint8 images: a smooth random field (anatomy-like
    low-frequency structure) plus pixel noise, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5A5A5A5A)
    h, w = shape
    coarse = torch.rand((count, 1, max(2, h // 64), max(2, w // 64)), generator=gen,
                        device=device)
    field = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                            align_corners=False)[:, 0]
    noise = torch.rand((count, h, w), generator=gen, device=device)
    return (field * 200.0 + noise * 55.0).to(torch.uint8)

"""A reference RGRG state dict -> the JAX package's parameter layout, in numpy.

The port's own copy of the conversion the JAX package applies to the
published checkpoints. Its output is the tree `core/convert.from_jax_params`
takes. The weight conventions it handles:

  - torch conv OIHW -> HWIO; torch Linear [out, in] -> [in, out];
  - GPT-2 (HF Conv1D) layers already store [in, out]: kept;
  - the torchvision RPN conv rename ("rpn.head.conv.weight" vs
    "rpn.head.conv.0.0.weight");
  - the reference backbone is an nn.Sequential, so its children are numbered
    ("backbone.0" is conv1, "backbone.4" is layer1, ...);
  - the box head's fc6 consumes a channel-major (NCHW) flatten; the tree's
    fc6 kernel is spatial-major (NHWC).

Pure numpy: pass `state_dict_to_numpy(torch.load(...))`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

RESNET50_STAGES = (3, 4, 6, 3)


def state_dict_to_numpy(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Detach a torch state dict into numpy arrays."""
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def strip_prefix(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def linear_kernel(w: np.ndarray) -> np.ndarray:
    """torch Linear [out, in] -> [in, out]."""
    return np.transpose(w, (1, 0))


def _bn(sd: Mapping[str, np.ndarray], key: str):
    params = {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}
    stats = {"mean": sd[f"{key}.running_mean"], "var": sd[f"{key}.running_var"]}
    return params, stats


def _conv(sd: Mapping[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    out = {"kernel": conv_kernel(sd[f"{key}.weight"])}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return out


def _linear(sd: Mapping[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    out = {"kernel": linear_kernel(sd[f"{key}.weight"])}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return out


def sequential_backbone_to_named(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The reference's nn.Sequential backbone keys -> torchvision names
    (0 conv1, 1 bn1, 2 relu, 3 maxpool, 4..7 layer1..4)."""
    rename = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
              "6": "layer3", "7": "layer4"}
    out = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if head in rename:
            out[f"{rename[head]}.{rest}" if rest else rename[head]] = v
    return out


def convert_resnet_backbone(sd: Mapping[str, np.ndarray], stage_sizes=RESNET50_STAGES):
    """torchvision-named ResNet keys (conv1, bn1, layerL.B.*) with
    `stage_sizes` bottleneck blocks per stage (ResNet-50 by default) ->
    {"params", "batch_stats"} of the backbone."""
    params: Dict[str, Any] = {"conv1": {"kernel": conv_kernel(sd["conv1.weight"])}}
    stats: Dict[str, Any] = {}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")
    for stage, num_blocks in enumerate(stage_sizes, start=1):
        for block in range(num_blocks):
            t, f = f"layer{stage}.{block}", f"layer{stage}_{block}"
            p: Dict[str, Any] = {}
            s: Dict[str, Any] = {}
            for i in (1, 2, 3):
                p[f"conv{i}"] = {"kernel": conv_kernel(sd[f"{t}.conv{i}.weight"])}
                p[f"bn{i}"], s[f"bn{i}"] = _bn(sd, f"{t}.bn{i}")
            if f"{t}.downsample.0.weight" in sd:
                p["downsample_conv"] = {"kernel": conv_kernel(sd[f"{t}.downsample.0.weight"])}
                p["downsample_bn"], s["downsample_bn"] = _bn(sd, f"{t}.downsample.1")
            params[f], stats[f] = p, s
    return {"params": params, "batch_stats": stats}


def fc6_kernel_nchw_to_nhwc(w: np.ndarray, channels: int = 2048, pool: int = 8) -> np.ndarray:
    """fc6 weight [out, C*P*P] (channel-major flatten) -> kernel
    [P*P*C, out] (spatial-major flatten)."""
    out_dim = w.shape[0]
    w = w.reshape(out_dim, channels, pool, pool)
    w = np.transpose(w, (0, 2, 3, 1)).reshape(out_dim, pool * pool * channels)
    return np.transpose(w, (1, 0))


def convert_rpn_head(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Keys under 'rpn.head.', either name of the conv."""
    conv_key = "conv" if "conv.weight" in sd else "conv.0.0"
    return {"conv": _conv(sd, conv_key), "cls_logits": _conv(sd, "cls_logits"),
            "bbox_pred": _conv(sd, "bbox_pred")}


def convert_classifier_mlp(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """nn.Sequential Linear/ReLU stack: classifier.0/2/4 -> fc0/fc1/fc2."""
    return {"fc0": _linear(sd, "classifier.0"), "fc1": _linear(sd, "classifier.2"),
            "fc2": _linear(sd, "classifier.4")}


def convert_detector(sd: Mapping[str, np.ndarray],
                     selection_sd: Optional[Mapping[str, np.ndarray]] = None,
                     abnormal_sd: Optional[Mapping[str, np.ndarray]] = None,
                     stage_sizes=RESNET50_STAGES) -> Dict[str, Any]:
    """A reference ObjectDetector state dict (backbone./rpn./roi_heads.)
    plus the two classifiers' -> {"params", "batch_stats"}. A classifier
    whose state dict is not given (a stage-1 detector checkpoint) is left
    out of the tree."""
    bb = convert_resnet_backbone(sequential_backbone_to_named(strip_prefix(sd, "backbone.")),
                                 stage_sizes)
    params: Dict[str, Any] = {"backbone": bb["params"]}
    stats: Dict[str, Any] = {"backbone": bb["batch_stats"]}
    params["rpn_head"] = convert_rpn_head(strip_prefix(sd, "rpn.head."))
    roi = strip_prefix(sd, "roi_heads.")
    head = strip_prefix(roi, "box_head.")
    params["box_head"] = {"fc6": {"kernel": fc6_kernel_nchw_to_nhwc(head["fc6.weight"]),
                                  "bias": head["fc6.bias"]},
                          "fc7": _linear(head, "fc7")}
    params["box_predictor"] = {"cls_score": _linear(roi, "box_predictor.cls_score"),
                               "bbox_pred": _linear(roi, "box_predictor.bbox_pred")}
    params["dim_reduction"] = _linear(roi, "dim_reduction")
    if selection_sd is not None:
        params["selection_classifier"] = convert_classifier_mlp(selection_sd)
    if abnormal_sd is not None:
        params["abnormal_classifier"] = convert_classifier_mlp(abnormal_sd)
    return {"params": params, "batch_stats": stats}


def _conv1d_hf(sd: Mapping[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    """HF Conv1D stores its weight [in, out]: kept."""
    return {"kernel": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _ln(sd: Mapping[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _gpt2_transformer(t: Mapping[str, np.ndarray], num_layers: int,
                      with_pseudo_attention: bool) -> Dict[str, Any]:
    """Keys at the HF GPT2Model level (wte.weight, h.{i}.attn.c_attn.weight,
    ...) -> decoder params without the feature transform. A plain HF
    GPT-2 has no uk/uv: they are zero."""
    d = t["wte.weight"].shape[1]
    params: Dict[str, Any] = {"wte": {"embedding": t["wte.weight"]},
                              "wpe": {"embedding": t["wpe.weight"]},
                              "ln_f": _ln(t, "ln_f")}
    zero = {"kernel": np.zeros((d, d), np.float32), "bias": np.zeros((d,), np.float32)}
    for i in range(num_layers):
        h = f"h.{i}"
        attn = {"c_attn": _conv1d_hf(t, f"{h}.attn.c_attn"),
                "c_proj": _conv1d_hf(t, f"{h}.attn.c_proj")}
        if with_pseudo_attention:
            attn.update(uk=_linear(t, f"{h}.attn.uk"), uv=_linear(t, f"{h}.attn.uv"))
        else:
            attn.update(uk=dict(zero), uv=dict(zero))
        params[f"h_{i}"] = {
            "ln_1": _ln(t, f"{h}.ln_1"),
            "ln_2": _ln(t, f"{h}.ln_2"),
            "attn": attn,
            "mlp": {"c_fc": _conv1d_hf(t, f"{h}.mlp.c_fc"),
                    "c_proj": _conv1d_hf(t, f"{h}.mlp.c_proj")},
        }
    return params


def convert_language_model(sd: Mapping[str, np.ndarray], num_layers: int = 24) -> Dict[str, Any]:
    """A reference LanguageModel state dict -> decoder params. The reference
    registers its modules under several paths; the canonical
    'gpt_with_lm_head.transformer.' one always exists and holds uk/uv."""
    params = _gpt2_transformer(strip_prefix(sd, "gpt_with_lm_head.transformer."),
                               num_layers, with_pseudo_attention=True)
    fst = strip_prefix(sd, "feature_space_transformation_nn.")
    params["feature_transform"] = {"fc0": _linear(fst, "0"), "fc1": _linear(fst, "2")}
    return params


def convert_hf_gpt2_lm(sd: Mapping[str, np.ndarray], num_layers: int) -> Dict[str, Any]:
    """A plain HF GPT2LMHeadModel state dict (transformer.* keys) -> decoder
    params, for vanilla GPT-2 generation (image_features=None, no_image) or
    pseudo-attention training from scratch: uk/uv and the D x D feature
    transform are zero."""
    params = _gpt2_transformer(strip_prefix(sd, "transformer."), num_layers,
                               with_pseudo_attention=False)
    d = params["wte"]["embedding"].shape[1]
    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    params["feature_transform"] = {"fc0": {"kernel": z(d, d), "bias": z(d)},
                                   "fc1": {"kernel": z(d, d), "bias": z(d)}}
    return params

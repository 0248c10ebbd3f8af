"""Training-state checkpoints, and loading a reference RGRG `.pt`.

`save_checkpoint` / `load_checkpoint` write and restore a whole
train.trainer.TrainState with torch.save: the detector's state dict (its
BatchNorm running statistics included), the decoder's tensors, the
optimizer (AdamW moments, the accumulated gradient mean and its mini-step,
the LR scale) and the step. A checkpoint is a directory holding
`train_state.pt`; loading reads it with weights_only=True into a state of
the same structure, bit for bit. `save_checkpoint` also takes a bare
params tree {"detector", "decoder"}, and `load_params` reads the params of
either kind into a new tree, which is how a trained model is served
(inference.ReportGenerator.from_checkpoint).

`load_torch_checkpoint` reads the file on the CPU and returns its model
state dict: the reference saves {"model": state_dict, "optimizer": ...,
...} (other entries are ignored), and a bare state dict loads as it is.
`convert_full_checkpoint` turns it into the JAX package's parameter layout
(numpy), which `core/convert.from_jax_params` carries into the port. It
takes a uniform nn.DataParallel "module." prefix and either torchvision
name of the RPN conv.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from rgrg_tpu_torch.core import torch_convert as tc
from rgrg_tpu_torch.core.config import ModelConfig
from rgrg_tpu_torch.core.device import DeviceLike, resolve_device
from rgrg_tpu_torch.models.detector import RegionDetector


def normalize_rpn_conv_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Newer torchvision saves 'rpn.head.conv.0.0.*', older 'rpn.head.conv.*':
    rename the new to the old where only the new is present."""
    out = dict(sd)
    for suffix in ("weight", "bias"):
        new, old = f"rpn.head.conv.0.0.{suffix}", f"rpn.head.conv.{suffix}"
        for prefix in ("", "object_detector."):
            if prefix + new in out and prefix + old not in out:
                out[prefix + old] = out.pop(prefix + new)
    return out


def convert_full_checkpoint(state_dict: Mapping[str, Any], num_layers: int = 24,
                            stage_sizes=tc.RESNET50_STAGES) -> Dict[str, Any]:
    """A reference ReportGenerationModel state dict (object_detector.*,
    binary_classifier_region_selection.*, binary_classifier_region_abnormal.*,
    language_model.*) -> {"detector": {"params", "batch_stats"},
    "decoder": ...} as numpy arrays. `num_layers` and `stage_sizes` (the
    backbone's blocks per stage) default to the reference's widths."""
    sd = tc.state_dict_to_numpy(state_dict)
    if sd and all(k.startswith("module.") for k in sd):
        sd = tc.strip_prefix(sd, "module.")
    sd = normalize_rpn_conv_keys(sd)
    out: Dict[str, Any] = {"detector": tc.convert_detector(
        tc.strip_prefix(sd, "object_detector."),
        selection_sd=tc.strip_prefix(sd, "binary_classifier_region_selection."),
        abnormal_sd=tc.strip_prefix(sd, "binary_classifier_region_abnormal."),
        stage_sizes=stage_sizes)}
    lm_sd = tc.strip_prefix(sd, "language_model.")
    if lm_sd:
        out["decoder"] = tc.convert_language_model(lm_sd, num_layers=num_layers)
    return out


def convert_detector_checkpoint(state_dict: Mapping[str, Any],
                                stage_sizes=tc.RESNET50_STAGES) -> Dict[str, Any]:
    """A stage-1 checkpoint, a bare ObjectDetector state dict (backbone.,
    rpn., roi_heads.) -> {"params", "batch_stats"} as numpy arrays, without
    the two classifiers (the reference trains them from stage 2 on)."""
    sd = normalize_rpn_conv_keys(tc.state_dict_to_numpy(state_dict))
    return tc.convert_detector(sd, stage_sizes=stage_sizes)


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """The model state dict of a reference `.pt`, loaded on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        return ckpt["model"]
    return ckpt


STATE_FILE = "train_state.pt"


def _decoder_flat(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_decoder_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return out


def save_checkpoint(path: str, state: Any) -> None:
    """Write a TrainState, or a bare params tree {"detector", "decoder"},
    to the directory `path` (replacing what is there), through a temporary
    file."""
    os.makedirs(path, exist_ok=True)
    params = getattr(state, "params", state)
    blob = {"detector": params["detector"].state_dict(),
            "decoder": _decoder_flat(params["decoder"])}
    if params is not state:
        blob.update(optimizer=state.opt_state.state_dict(), step=int(state.step))
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


@torch.no_grad()
def load_checkpoint(path: str, target: Any) -> Any:
    """Restore the TrainState saved under `path` into `target` (built for
    the same model, stage and optimizer) in place, and return it."""
    blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    target.params["detector"].load_state_dict(blob["detector"])
    dec = _decoder_flat(target.params["decoder"])
    if set(dec) != set(blob["decoder"]):
        raise ValueError(f"decoder tensors differ from the checkpoint's: "
                         f"{sorted(set(dec) ^ set(blob['decoder']))[:8]}")
    for name, t in dec.items():
        t.copy_(blob["decoder"][name])
    target.opt_state.load_state_dict(blob["optimizer"])
    target.step = int(blob["step"])
    return target


def load_params(path: str, cfg: ModelConfig, device: DeviceLike = None) -> Dict[str, Any]:
    """The params {"detector": RegionDetector in eval mode, "decoder": tree
    of tensors} of the checkpoint under `path`, a TrainState's or a bare
    tree's alike, on `device` (default cuda). The detector is built for
    `cfg.detector` (its dtype casts the saved tensors); the decoder keeps
    the saved dtypes."""
    dev = resolve_device(device)
    blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    detector = RegionDetector(cfg.detector, device=dev)
    detector.load_state_dict(blob["detector"])
    detector.eval()
    decoder = _unflatten({k: t.to(dev) for k, t in blob["decoder"].items()})
    return {"detector": detector, "decoder": decoder}

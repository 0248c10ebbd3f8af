"""Carry the JAX package's parameters across to the port.

`from_jax_params` takes the parameter tree as `RGRG.init` builds it in the
JAX package, as numpy arrays:

    {"detector": {"params": {...}, "batch_stats": {...}},
     "decoder": {"wte": {"embedding"}, "h_0": {...}, ...}}

and returns the port's params, {"detector": RegionDetector, "decoder":
dict of tensors}, with every tensor on `device`. Layout changes:

  - flax convs HWIO -> OIHW;
  - flax Dense [in, out] -> torch Linear weight [out, in];
  - the spatial-major fc6 kernel [P*P*C, rep] is kept as is (the port's
    Fc6 contracts the NHWC-pooled map flattened as (p, q, c));
  - GPT-2 Conv1D kernels [in, out] are kept as is;
  - BatchNorm scale/bias -> weight/bias, running statistics from
    batch_stats mean/var.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from rgrg_tpu_torch.core.config import ModelConfig
from rgrg_tpu_torch.core.device import DeviceLike, resolve_device
from rgrg_tpu_torch.models.detector import RegionDetector
from rgrg_tpu_torch.models.heads import Fc6
from rgrg_tpu_torch.models.layers import BatchNorm2d, Conv2d, Linear


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: go through f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


def _subtree(tree: Mapping[str, Any], dotted: str) -> Mapping[str, Any]:
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def _leaf_paths(tree: Mapping[str, Any], prefix: str = "") -> set:
    out = set()
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out |= _leaf_paths(v, path + ".") if isinstance(v, Mapping) else {path}
    return out


def _copy(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(src.to(dst.dtype))


@torch.no_grad()
def load_detector_(detector: RegionDetector, variables: Mapping[str, Any],
                   strict: bool = True) -> None:
    """Copy the flax detector variables {"params", "batch_stats"} into
    `detector` in place. Every parameter and statistic must be consumed.
    strict=False lets a top-level module the variables lack (a stage-1
    checkpoint's classifiers) keep its values."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    used = set()
    for name, m in detector.named_modules():
        if not strict and name and name.split(".")[0] not in params:
            continue
        if isinstance(m, Conv2d):
            p = _subtree(params, name)
            _copy(m.weight, _tensor(p["kernel"]).permute(3, 2, 0, 1), name)
            used.add(f"params.{name}.kernel")
            if m.bias is not None:
                _copy(m.bias, _tensor(p["bias"]), name)
                used.add(f"params.{name}.bias")
        elif isinstance(m, (Linear, Fc6)):
            p = _subtree(params, name)
            kernel = _tensor(p["kernel"])
            if isinstance(m, Linear):
                _copy(m.weight, kernel.T, name)
            else:
                _copy(m.kernel, kernel, name)
            _copy(m.bias, _tensor(p["bias"]), name)
            used |= {f"params.{name}.kernel", f"params.{name}.bias"}
        elif isinstance(m, BatchNorm2d):
            p, s = _subtree(params, name), _subtree(stats, name)
            _copy(m.weight, _tensor(p["scale"]), name)
            _copy(m.bias, _tensor(p["bias"]), name)
            _copy(m.running_mean, _tensor(s["mean"]), name)
            _copy(m.running_var, _tensor(s["var"]), name)
            used |= {f"params.{name}.scale", f"params.{name}.bias",
                     f"batch_stats.{name}.mean", f"batch_stats.{name}.var"}
    unused = _leaf_paths({"params": params, "batch_stats": stats}) - used
    if unused:
        raise ValueError(f"detector variables without a place in the port: "
                         f"{sorted(unused)[:8]}")


def decoder_from_jax(tree: Mapping[str, Any], device: torch.device) -> Dict[str, Any]:
    """Nested dict of arrays -> the same nesting of tensors on `device`
    (GPT-2 Conv1D kernels stay [in, out]; dtypes are kept)."""
    if isinstance(tree, Mapping):
        return {k: decoder_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree).to(device)


def from_jax_params(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's {"detector", "decoder"} tree -> the port's params."""
    dev = resolve_device(device)
    detector = RegionDetector(cfg.detector, device=dev)
    load_detector_(detector, tree["detector"])
    detector.eval()
    return {"detector": detector,
            "decoder": decoder_from_jax(tree["decoder"], dev)}

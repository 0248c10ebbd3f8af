"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means `cuda`. Asking for `cuda` without a usable card raises;
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def dtype_of(name: Optional[str]) -> torch.dtype:
    """Config dtype string ("float32" / "bfloat16") -> torch dtype."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return table[name]

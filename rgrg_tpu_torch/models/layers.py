"""Layers that keep f32 parameters and compute in the input's dtype.

The detector's parameters stay f32 while its convs and dense layers run in
the configured compute dtype (bf16 for serving): each layer casts its
weights to the input's dtype at use. Eval BatchNorm works from running
statistics in f32, y = (x - mean) * (rsqrt(var + eps) * scale) + bias, and
returns the input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                        dtype=torch.float32) / math.sqrt(fan_in))


class Conv2d(nn.Conv2d):
    """NCHW convolution; weight OIHW f32, cast to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        _, fan_in, kh, kw = self.weight.shape
        _lecun_normal_(self.weight, fan_in * kh * kw, generator)
        if self.bias is not None:
            self.bias.zero_()


class Linear(nn.Linear):
    """y = x @ W.T + b with W [out, in] f32, cast to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.in_features, generator)
        self.bias.zero_()


class FrozenBatchNorm2d(nn.Module):
    """Eval-mode BatchNorm over NCHW from running statistics."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = ((x.to(torch.float32) - self.running_mean[:, None, None])
             * mul[:, None, None] + self.bias[:, None, None])
        return y.to(x.dtype)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        del generator  # identity statistics, unit scale, zero shift
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


def init_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init of every layer above (lecun-normal weights, zero
    biases, identity BatchNorm), in module order."""
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(generator)
    return module

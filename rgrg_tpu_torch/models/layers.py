"""Layers that keep f32 parameters and compute in the input's dtype.

The detector's parameters stay f32 while its convs and dense layers run in
the configured compute dtype (bf16 for serving): each layer casts its
weights to the input's dtype at use. BatchNorm normalises in f32,
y = (x - mean) * (rsqrt(var + eps) * scale) + bias, and returns the input's
dtype: in eval mode from its running statistics, in train mode from the
batch's (flax.linen.BatchNorm's semantics, momentum 0.9). Under a
data-parallel mesh (core/mesh.active) train mode takes the global batch's
statistics.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rgrg_tpu_torch.core import mesh as mesh_lib


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


class BatchNorm2d(nn.Module):
    """BatchNorm over NCHW, computed in f32 (f64 for f64 input). Eval mode
    (how the detector serves) normalises with the running statistics. Train
    mode normalises with the batch's statistics over (N, H, W), as flax
    computes them: mean and mean of squares, variance = max(0, E[x^2] -
    E[x]^2) (biased), and moves the running statistics to 0.9 * running +
    0.1 * batch, the variance biased too (F.batch_norm would store the
    unbiased one). The batch is the global one of the mesh
    (core/mesh.current; without one, this process's): the per-channel sums
    of x and x^2 are all-reduced over the ranks (the gradient flows back
    through the reduction), so statistics, running statistics and gradients
    are those of the whole batch."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))   # f64 stays f64
        if self.training:
            mesh = mesh_lib.current()
            c = xf.shape[1]
            sums = mesh_lib.all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)),
                                                  (xf * xf).sum(dim=(0, 2, 3))]), mesh)
            n = xf.numel() // c * mesh.size
            mean, meansq = sums[:c] / n, sums[c:] / n
            var = torch.clamp(meansq - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1.0 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
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

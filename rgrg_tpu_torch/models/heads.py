"""Detection heads: RPN head, TwoMLP box head (spatial-major fc6), Fast
R-CNN predictor and the binary-classifier MLP."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rgrg_tpu_torch.models.layers import Conv2d, Linear


class RPNHead(nn.Module):
    """3x3 conv + relu, then 1x1 objectness / box-delta convs. Outputs are
    flattened in (y, x, anchor) order, the anchor grid's order."""

    def __init__(self, in_channels: int = 2048, num_anchors: int = 160,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1, device=device)
        self.cls_logits = Conv2d(in_channels, num_anchors, 1, device=device)
        self.bbox_pred = Conv2d(in_channels, num_anchors * 4, 1, device=device)

    def forward(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats [B, H, W, C] NHWC -> (objectness [B, H*W*A],
        deltas [B, H*W*A, 4]) in the feature dtype."""
        b = feats.shape[0]
        x = feats.permute(0, 3, 1, 2)  # NCHW view of the NHWC map
        t = F.relu(self.conv(x))
        objectness = self.cls_logits(t).permute(0, 2, 3, 1).reshape(b, -1)
        deltas = self.bbox_pred(t).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return objectness, deltas


class Fc6(nn.Module):
    """fc6 over the pooled (P, P, C) map. The kernel is [P*P*C, rep] in
    spatial-major order, so the NHWC pooled map flattens as (p, q, c)."""

    def __init__(self, in_features: int, out_features: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, pooled: torch.Tensor, dtype: torch.dtype,
                kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pooled [..., P, P, C] -> [..., rep] in `dtype`. `kernel` may pass
        the weight already cast to `dtype` (the RoI head casts it once per
        forward, not once per chunk)."""
        k = self.kernel.to(dtype) if kernel is None else kernel
        x = pooled.to(dtype).reshape(pooled.shape[:-3] + (-1,))
        return torch.matmul(x, k) + self.bias.to(dtype)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        self.kernel.copy_(torch.randn(self.kernel.shape, generator=generator,
                                      device=self.kernel.device)
                          / math.sqrt(self.kernel.shape[0]))
        self.bias.zero_()


class TwoMLPHead(nn.Module):
    """fc6/fc7 of the Fast R-CNN box head over NHWC-pooled [..., P, P, C]."""

    def __init__(self, in_features: int, representation_size: int = 1024,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.fc6 = Fc6(in_features, representation_size, device=device)
        self.fc7 = Linear(representation_size, representation_size, device=device)

    def forward(self, pooled: torch.Tensor, dtype: torch.dtype,
                fc6_kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.relu(self.fc6(pooled, dtype, fc6_kernel))
        return F.relu(self.fc7(x))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int = 1024, num_classes: int = 30,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes, device=device)
        self.bbox_pred = Linear(in_features, num_classes * 4, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


class BinaryClassifierMLP(nn.Module):
    """1024 -> 512 -> 128 -> 1 with ReLU, in f32 whatever the detector's
    compute dtype (region selection and abnormality)."""

    def __init__(self, in_features: int = 1024, hidden=(512, 128),
                 device: Optional[torch.device] = None):
        super().__init__()
        self.fc0 = Linear(in_features, hidden[0], device=device)
        self.fc1 = Linear(hidden[0], hidden[1], device=device)
        self.fc2 = Linear(hidden[1], 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc0(x.to(torch.float32)))
        x = F.relu(self.fc1(x))
        return self.fc2(x)[..., 0]

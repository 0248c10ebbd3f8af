"""ResNet-v1 backbone up to C5, 1-channel stem.

BatchNorm follows the module's mode: `.eval()` normalises with the running
statistics (serving, evaluation), `.train()` with the batch's and updates
the running statistics (models/layers.BatchNorm2d).

torchvision structure (bottleneck with the stride on the 3x3 conv, BN eps
1e-5, maxpool 3x3/2 pad 1 with -inf padding). The public layout is NHWC:
[B, 512, 512, 1] in, [B, 16, 16, 2048] out. Inside, the convs run NCHW; on
the card the NHWC input permutes into a channels-last NCHW view, which
cuDNN consumes without a copy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rgrg_tpu_torch.models.layers import BatchNorm2d, Conv2d


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride here) -> 1x1 expand, + identity."""

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 has_downsample: bool = False, expansion: int = 4,
                 device: Optional[torch.device] = None):
        super().__init__()
        out_ch = width * expansion
        kw = dict(bias=False, device=device)
        self.conv1 = Conv2d(in_ch, width, 1, **kw)
        self.bn1 = BatchNorm2d(width, device=device)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, **kw)
        self.bn2 = BatchNorm2d(width, device=device)
        self.conv3 = Conv2d(width, out_ch, 1, **kw)
        self.bn3 = BatchNorm2d(out_ch, device=device)
        if has_downsample:
            self.downsample_conv = Conv2d(in_ch, out_ch, 1, stride=stride, **kw)
            self.downsample_bn = BatchNorm2d(out_ch, device=device)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + identity)


class ResNetBackbone(nn.Module):
    """stage_sizes (3, 4, 6, 3) == ResNet-50."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 in_channels: int = 1, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = dtype
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False,
                            device=device)
        self.bn1 = BatchNorm2d(64, device=device)
        self.block_names = []
        in_ch, width = 64, 64
        for stage, num_blocks in enumerate(stage_sizes):
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, Bottleneck(
                    in_ch, width, stride=stride, has_downsample=block == 0,
                    device=device))
                self.block_names.append(name)
                in_ch = width * 4
            width *= 2

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, in_channels] NHWC -> C5 [B, H/32, W/32, 2048]."""
        if images.ndim != 4 or images.shape[-1] != self.in_channels:
            raise ValueError(f"expected NHWC input with {self.in_channels} "
                             f"channels, got {tuple(images.shape)}")
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for name in self.block_names:
            y = getattr(self, name)(y)
        return y.permute(0, 2, 3, 1).contiguous()

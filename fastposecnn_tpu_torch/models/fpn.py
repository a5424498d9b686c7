"""FPN decoder and segmentation head in NCHW with smp's state_dict layout
(counterpart of the JAX package's `models/fpn.py`).

1x1 laterals to 256 channels, nearest x2 top-down adds, per-level
segmentation blocks (conv3x3 + GroupNorm(32, eps 1e-5) + ReLU, with bilinear
x2 upsamples, align_corners=True) down to 128 channels at 1/4 resolution,
'add' merge, Dropout2d; the head is a 1x1 conv plus a x4 bilinear upsample
(align_corners=True).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=True)


class Conv3x3GNReLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, upsample: bool):
        super().__init__()
        self.upsample = upsample
        self.block = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            nn.GroupNorm(32, out_ch, eps=1e-5),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.block(x)
        return upsample_bilinear(x, 2) if self.upsample else x


class FPNBlock(nn.Module):
    def __init__(self, pyramid_ch: int, skip_ch: int):
        super().__init__()
        self.skip_conv = nn.Conv2d(skip_ch, pyramid_ch, kernel_size=1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2, mode="nearest") + self.skip_conv(skip)


class SegmentationBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_upsamples: int = 0):
        super().__init__()
        blocks = [Conv3x3GNReLU(in_ch, out_ch, upsample=n_upsamples > 0)]
        blocks += [Conv3x3GNReLU(out_ch, out_ch, upsample=True)
                   for _ in range(1, n_upsamples)]
        self.block = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class FPNDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 pyramid_channels: int = 256,
                 segmentation_channels: int = 128, dropout: float = 0.2):
        super().__init__()
        c5, c4, c3, c2 = tuple(encoder_channels)[::-1][:4]
        self.p5 = nn.Conv2d(c5, pyramid_channels, kernel_size=1)
        self.p4 = FPNBlock(pyramid_channels, c4)
        self.p3 = FPNBlock(pyramid_channels, c3)
        self.p2 = FPNBlock(pyramid_channels, c2)
        self.seg_blocks = nn.ModuleList([
            SegmentationBlock(pyramid_channels, segmentation_channels, n)
            for n in (3, 2, 1, 0)
        ])
        self.dropout = nn.Dropout2d(p=dropout)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        c2, c3, c4, c5 = features[-4:]
        p5 = self.p5(c5)
        p4 = self.p4(p5, c4)
        p3 = self.p3(p4, c3)
        p2 = self.p2(p3, c2)
        maps = [blk(p) for blk, p in zip(self.seg_blocks, (p5, p4, p3, p2))]
        return self.dropout(maps[0] + maps[1] + maps[2] + maps[3])


class SegmentationHead(nn.Sequential):
    def __init__(self, in_ch: int, out_ch: int, upsampling: int = 4):
        layers = [nn.Conv2d(in_ch, out_ch, kernel_size=1)]
        if upsampling > 1:
            layers.append(nn.UpsamplingBilinear2d(scale_factor=upsampling))
        super().__init__(*layers)

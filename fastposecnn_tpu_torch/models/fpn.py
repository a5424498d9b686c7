"""FPN decoder and segmentation head in NCHW with smp's state_dict layout
(counterpart of the JAX package's `models/fpn.py`).

1x1 laterals to 256 channels, nearest x2 top-down adds, per-level
segmentation blocks (conv3x3 + GroupNorm(32, eps 1e-5) + ReLU, with bilinear
x2 upsamples, align_corners=True) down to 128 channels at 1/4 resolution,
'add' merge, channel dropout; the head is a 1x1 conv plus a x4 bilinear
upsample (align_corners=True).

The dropout is flax's `nn.Dropout(broadcast_dims=(1, 2))` of the JAX
decoder (`models/fpn.py:148-152`): in training a [B, C, 1, 1] keep mask
selects whole channels, scaled by 1/(1-p). The mask can be injected (so
that a step can replay another framework's draws); otherwise it is drawn
from the generator given, or from torch's default one.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
        self.dropout = dropout
        self.channels = segmentation_channels

    def forward(self, features: Sequence[torch.Tensor],
                keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c2, c3, c4, c5 = features[-4:]
        p5 = self.p5(c5)
        p4 = self.p4(p5, c4)
        p3 = self.p3(p4, c3)
        p2 = self.p2(p3, c2)
        maps = [blk(p) for blk, p in zip(self.seg_blocks, (p5, p4, p3, p2))]
        x = maps[0] + maps[1] + maps[2] + maps[3]
        if not self.training or self.dropout == 0.0:
            return x
        if keep is None:
            keep = draw_keep(x.shape[0], self.channels, self.dropout,
                             x.device, generator)
        return torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))


def draw_keep(batch: int, channels: int, rate: float, device,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A channel keep mask [B, C, 1, 1] (bool): each channel kept with
    probability 1 - rate, as flax's `random.bernoulli`."""
    u = torch.rand((batch, channels, 1, 1), generator=generator, device=device)
    return u < 1.0 - rate


class SegmentationHead(nn.Sequential):
    def __init__(self, in_ch: int, out_ch: int, upsampling: int = 4):
        layers = [nn.Conv2d(in_ch, out_ch, kernel_size=1)]
        if upsampling > 1:
            layers.append(nn.UpsamplingBilinear2d(scale_factor=upsampling))
        super().__init__(*layers)

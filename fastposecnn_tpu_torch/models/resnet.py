"""ResNet18 encoder in NCHW with torchvision's state_dict layout
(counterpart of the JAX package's `models/resnet.py`).

Returns the 6-feature pyramid [identity, stem (1/2), layer1 (1/4),
layer2 (1/8), layer3 (1/16), layer4 (1/32)] with channels
(3, 64, 64, 128, 256, 512). The JAX stem pads RGB to 4 channels with a zero
alpha channel; here the stem takes 3 channels and `weights.from_jax_params`
drops the zero alpha input channel of the converted kernel.
BatchNorm eps is 1e-5. In training, `BatchNorm` updates its running
statistics as flax does (`models/resnet.py:53-59` of the JAX package):
momentum 0.9 on the batch mean and the biased batch variance, where
`nn.BatchNorm2d` would take the unbiased one.

The stem max pool is `nn.MaxPool2d`: its backward routes each window's
cotangent to the first maximum in row-major order, the tie rule of the JAX
package's custom VJP (`ops/pooling.py`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

FLAX_MOMENTUM = 0.9


class BatchNorm(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (same parameters, buffers and state_dict keys)
    whose train-mode forward normalizes with the biased batch statistics
    and updates the running ones as flax: r <- 0.9 r + 0.1 s, with s the
    batch mean and the biased batch variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.copy_(FLAX_MOMENTUM * self.running_mean
                                    + (1.0 - FLAX_MOMENTUM) * mean)
            self.running_var.copy_(FLAX_MOMENTUM * self.running_var
                                   + (1.0 - FLAX_MOMENTUM) * var)
            self.num_batches_tracked.add_(1)
        return y


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = BatchNorm(out_ch, eps=1e-5)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(out_ch, eps=1e-5)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                BatchNorm(out_ch, eps=1e-5),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + identity)


class ResNetEncoder(nn.Module):
    out_channels = (3, 64, 64, 128, 256, 512)

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, eps=1e-5)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for i, width in enumerate((64, 128, 256, 512)):
            blocks = []
            for b in range(2):
                blocks.append(BasicBlock(in_ch, width,
                                         2 if (b == 0 and i > 0) else 1))
                in_ch = width
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        features = [x]
        y = torch.relu(self.bn1(self.conv1(x)))
        features.append(y)
        y = self.maxpool(y)
        for i in range(4):
            y = getattr(self, f"layer{i + 1}")(y)
            features.append(y)
        return features

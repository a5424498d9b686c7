"""ResNet18, ResNet34 and ResNet50 encoders in NCHW with torchvision's
state_dict layout (counterpart of the JAX package's `models/resnet.py`).

Returns the 6-feature pyramid [identity, stem (1/2), layer1 (1/4),
layer2 (1/8), layer3 (1/16), layer4 (1/32)] with channels
(3, 64, 64, 128, 256, 512) for resnet18 and resnet34 and
(3, 64, 256, 512, 1024, 2048) for resnet50 (`RESNET_SPECS`). ResNet50's
bottleneck blocks stride on their 3x3 `conv2`, as the JAX block and
torchvision's v1.5, and a block has a downsample branch wherever its
residual's shape differs from its output's: at every stage's first block
but resnet18's and resnet34's first stage, and at resnet50's `layer1.0`,
whose stride is 1 but whose channels go from 64 to 256.

The JAX stem pads RGB to 4 channels with a zero alpha channel; here the
stem takes 3 channels and `weights.from_jax_params` drops the zero alpha
input channel of the converted kernel. Every BatchNorm (the bottleneck's
`bn3` and the downsample's too) has eps 1e-5. In training, `BatchNorm`
normalizes with flax's fast variance, E[x^2] - E[x]^2, and updates its
running statistics as flax does (`models/resnet.py:53-59` of the JAX
package): momentum 0.9 on the batch mean and that biased batch variance,
where `nn.BatchNorm2d` would take the unbiased one.

The stem max pool is `nn.MaxPool2d`: its backward routes each window's
cotangent to the first maximum in row-major order, the tie rule of the JAX
package's custom VJP (`ops/pooling.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from fastposecnn_tpu_torch.parallel import mesh

FLAX_MOMENTUM = 0.9


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    block: str  # 'basic' | 'bottleneck'
    stage_sizes: Tuple[int, ...]
    out_channels: Tuple[int, ...]


RESNET_SPECS = {
    "resnet18": ResNetSpec("basic", (2, 2, 2, 2), (3, 64, 64, 128, 256, 512)),
    "resnet34": ResNetSpec("basic", (3, 4, 6, 3), (3, 64, 64, 128, 256, 512)),
    "resnet50": ResNetSpec("bottleneck", (3, 4, 6, 3), (3, 64, 256, 512, 1024, 2048)),
}


class BatchNorm(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (same parameters, buffers and state_dict keys)
    whose train-mode forward normalizes as flax's `nn.BatchNorm` with its
    default fast variance: from the per-channel sum and sum of squares, the
    mean and the biased variance E[x^2] - E[x]^2 clamped at 0; it updates
    the running statistics as flax does, r <- 0.9 r + 0.1 s, from the same
    mean and variance.

    Inside a process group (`parallel.mesh`), the batch is the global one:
    the sums are summed over the ranks in one all-reduce that carries
    gradient, so every rank normalizes with the global batch's statistics
    and holds the same running ones. One process takes the same code path
    without the all-reduce."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        c = x.shape[1]
        n = x.numel() // c * mesh.world_size()  # every rank holds as many rows
        stats = mesh.all_reduce_sum(torch.cat([x.sum(dim=(0, 2, 3)),
                                               (x * x).sum(dim=(0, 2, 3))]))
        mean = stats[:c] / n
        var = (stats[c:] / n - mean * mean).clamp_min(0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]
        with torch.no_grad():
            self._update_running(mean, var)
        return y

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.copy_(FLAX_MOMENTUM * self.running_mean
                                + (1.0 - FLAX_MOMENTUM) * mean)
        self.running_var.copy_(FLAX_MOMENTUM * self.running_var
                               + (1.0 - FLAX_MOMENTUM) * var)
        self.num_batches_tracked.add_(1)


def _downsample(in_ch: int, out_ch: int, stride: int):
    """The residual's 1x1 projection where its shape differs from the
    block's output (the JAX block's `residual.shape != y.shape`)."""
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                         BatchNorm(out_ch, eps=1e-5))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = BatchNorm(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(width, eps=1e-5)
        self.downsample = _downsample(in_ch, width, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + identity)


class BottleneckBlock(nn.Module):
    """1x1 to `width`, 3x3 at `stride`, 1x1 to 4 `width`."""
    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = width * self.expansion
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = BatchNorm(width, eps=1e-5)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch, eps=1e-5)
        self.downsample = _downsample(in_ch, out_ch, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + identity)


class ResNetEncoder(nn.Module):
    """The encoder `name` of `RESNET_SPECS`; any other name raises."""

    def __init__(self, name: str = "resnet18"):
        super().__init__()
        if name not in RESNET_SPECS:
            raise ValueError(f"unknown encoder {name!r}; one of {sorted(RESNET_SPECS)}")
        spec = RESNET_SPECS[name]
        self.encoder_name = name
        self.out_channels = spec.out_channels
        block = BasicBlock if spec.block == "basic" else BottleneckBlock
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, eps=1e-5)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for i, (blocks, width) in enumerate(zip(spec.stage_sizes, (64, 128, 256, 512))):
            layer = []
            for b in range(blocks):
                layer.append(block(in_ch, width, 2 if (b == 0 and i > 0) else 1))
                in_ch = width * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor):
        features = [x]
        y = torch.relu(self.bn1(self.conv1(x)))
        features.append(y)
        y = self.maxpool(y)
        for i in range(4):
            y = getattr(self, f"layer{i + 1}")(y)
            features.append(y)
        return features

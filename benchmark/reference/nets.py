"""The plain reference network: FastPoseCNN's PoseRegressor in float32.

A ResNet encoder (resnet18 or resnet50), four FPN decoders of 256
pyramid and 128 segmentation channels (conv3x3 + GroupNorm(32) + ReLU
blocks with bilinear x2 upsamples, align_corners=True; nearest x2
top-down adds; 'add' merge; channel dropout 0.2 by given keep masks) and
four heads (a 1x1 convolution and a bilinear x4 upsample), written as the
published architecture is, with plain `torch.nn` modules. Module names are
the port's state_dict layout, so one state_dict loads into both.

Two departures from `torch.nn`'s defaults, both the JAX package's (and so
the port's) semantics: BatchNorm normalises a training batch with the
biased variance E[x^2] - E[x]^2 and updates its running statistics with
momentum 0.9 (flax); the translation head's channels split into xy (j % 3
!= 2) and z (j % 3 == 2).

`operands` selects how the convolutions round their operands, for the
controls: None (float32, as stated), "fp8" (input, weight and output
rounded to float8 e4m3 with a per-tensor scale, the gradients of each to
e5m2, as an fp8 convolution computes) or "tf32"
(input and weight rounded to TF32's 10-bit mantissa, for a device without
TF32 units; on the card the control turns the TF32 flags on instead).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2), (3, 64, 64, 128, 256, 512)),
    "resnet50": ("bottleneck", (3, 4, 6, 3), (3, 64, 256, 512, 1024, 2048)),
}
DECODERS = ("mask", "rotation", "translation", "scales")


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = (x.detach().abs().amax() / top).clamp_min(1e-30)
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to 10 mantissa bits (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Conv2d(nn.Conv2d):
    operands: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.operands == "fp8":
            y = self._conv_forward(_RoundFp8.apply(x), _RoundFp8.apply(w), None)
            y = _RoundFp8.apply(y)
            return y if self.bias is None else y + self.bias[None, :, None, None]
        if self.operands == "tf32":
            x, w = _tf32(x), _tf32(w)
        return self._conv_forward(x, w, self.bias)


class BatchNorm(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        c = x.shape[1]
        n = x.numel() // c
        mean = x.sum(dim=(0, 2, 3)) / n
        var = ((x * x).sum(dim=(0, 2, 3)) / n - mean * mean).clamp_min(0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        return y


def _down(cin, cout, stride):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(Conv2d(cin, cout, 1, stride=stride, bias=False),
                         BatchNorm(cout, eps=1e-5))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, width, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(width, eps=1e-5)
        self.conv2 = Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(width, eps=1e-5)
        self.downsample = _down(cin, width, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm(width, eps=1e-5)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(width, eps=1e-5)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = BatchNorm(width * 4, eps=1e-5)
        self.downsample = _down(cin, width * 4, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + identity)


class Encoder(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        kind, stages, self.out_channels = SPECS[name]
        block = BasicBlock if kind == "basic" else BottleneckBlock
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, eps=1e-5)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for i, (n, width) in enumerate(zip(stages, (64, 128, 256, 512))):
            layers = []
            for b in range(n):
                layers.append(block(cin, width, 2 if (b == 0 and i > 0) else 1))
                cin = width * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*layers))

    def forward(self, x):
        feats = [x]
        y = torch.relu(self.bn1(self.conv1(x)))
        feats.append(y)
        y = self.maxpool(y)
        for i in range(4):
            y = getattr(self, f"layer{i + 1}")(y)
            feats.append(y)
        return feats


def _up(x, scale):
    return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=True)


class Conv3x3GNReLU(nn.Module):
    def __init__(self, cin, cout, upsample):
        super().__init__()
        self.upsample = upsample
        self.block = nn.Sequential(Conv2d(cin, cout, 3, padding=1, bias=False),
                                   nn.GroupNorm(32, cout, eps=1e-5), nn.ReLU())

    def forward(self, x):
        x = self.block(x)
        return _up(x, 2) if self.upsample else x


class FPNBlock(nn.Module):
    def __init__(self, pyramid, skip):
        super().__init__()
        self.skip_conv = Conv2d(skip, pyramid, kernel_size=1)

    def forward(self, x, skip):
        return F.interpolate(x, scale_factor=2, mode="nearest") + self.skip_conv(skip)


class SegmentationBlock(nn.Module):
    def __init__(self, cin, cout, n_up):
        super().__init__()
        blocks = [Conv3x3GNReLU(cin, cout, n_up > 0)]
        blocks += [Conv3x3GNReLU(cout, cout, True) for _ in range(1, n_up)]
        self.block = nn.Sequential(*blocks)

    def forward(self, x):
        return self.block(x)


class FPNDecoder(nn.Module):
    def __init__(self, enc_channels, pyramid=256, seg=128, dropout=0.2):
        super().__init__()
        self.channels, self.dropout = seg, dropout
        c5, c4, c3, c2 = tuple(enc_channels)[::-1][:4]
        self.p5 = Conv2d(c5, pyramid, kernel_size=1)
        self.p4 = FPNBlock(pyramid, c4)
        self.p3 = FPNBlock(pyramid, c3)
        self.p2 = FPNBlock(pyramid, c2)
        self.seg_blocks = nn.ModuleList(
            [SegmentationBlock(pyramid, seg, n) for n in (3, 2, 1, 0)])

    def forward(self, feats, keep=None):
        c2, c3, c4, c5 = feats[-4:]
        p5 = self.p5(c5)
        p4 = self.p4(p5, c4)
        p3 = self.p3(p4, c3)
        p2 = self.p2(p3, c2)
        maps = [blk(p) for blk, p in zip(self.seg_blocks, (p5, p4, p3, p2))]
        x = maps[0] + maps[1] + maps[2] + maps[3]
        if not self.training:
            return x
        return torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))


class Head(nn.Sequential):
    def __init__(self, cin, cout, upsampling=4):
        super().__init__(Conv2d(cin, cout, kernel_size=1))
        self.upsampling = upsampling

    def forward(self, x):
        return _up(self[0](x), self.upsampling)


class PoseRegressor(nn.Module):
    def __init__(self, num_classes: int = 7, encoder: str = "resnet18",
                 operands: Optional[str] = None, pyramid: int = 256, seg: int = 128,
                 dropout: float = 0.2, upsampling: int = 4):
        super().__init__()
        c = num_classes
        self.encoder = Encoder(encoder)
        ec = self.encoder.out_channels
        for name in DECODERS:
            setattr(self, f"{name}_decoder", FPNDecoder(ec, pyramid, seg, dropout))
        self.segmentation_head = Head(seg, c, upsampling)
        self.rotation_head = Head(seg, 4 * (c - 1), upsampling)
        self.translation_head = Head(seg, 3 * (c - 1), upsampling)
        self.scales_head = Head(seg, 3 * (c - 1), upsampling)
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.operands = operands

    def forward(self, x, dropout_keep: Optional[Dict[str, torch.Tensor]] = None):
        feats = self.encoder(x)
        keep = dropout_keep or {}
        dec = {n: getattr(self, f"{n}_decoder")(feats, keep.get(n)) for n in DECODERS}
        xyz = self.translation_head(dec["translation"])
        n = xyz.shape[1]
        xy_idx = torch.tensor([i for i in range(n) if i % 3 != 2], device=x.device)
        z_idx = torch.tensor([i for i in range(n) if i % 3 == 2], device=x.device)
        return {
            "mask": self.segmentation_head(dec["mask"]),
            "quaternion": self.rotation_head(dec["rotation"]),
            "xy": xyz.index_select(1, xy_idx),
            "z": xyz.index_select(1, z_idx),
            "scales": self.scales_head(dec["scales"]),
        }


HEADS = {"mask": "segmentation_head", "rotation": "rotation_head",
         "translation": "translation_head", "scales": "scales_head"}


def from_config(cfg: Dict, operands: Optional[str] = None) -> PoseRegressor:
    """The network a configuration file states (`configs/<name>.json`):
    its encoder, classes, decoder widths, dropout and head upsampling. Only
    the 'add' merge and the four decoders are built; another value raises."""
    if cfg["decoder_merge_policy"] != "add" or tuple(cfg["decoders"]) != DECODERS:
        raise ValueError("the reference builds the four decoders with the 'add' merge only")
    return PoseRegressor(len(cfg["classes"]), cfg["encoder"], operands=operands,
                         pyramid=cfg["decoder_pyramid_channels"],
                         seg=cfg["decoder_segmentation_channels"],
                         dropout=cfg["decoder_dropout"], upsampling=cfg["head_upsampling"])


def config_mismatches(cfg: Dict, net: nn.Module) -> List[str]:
    """What of the configuration's stated sizes `net` (the reference's or
    the port's network: both name their modules alike) does not have: its
    parameter count, each decoder's pyramid and segmentation widths and
    dropout, each head's channels and upsampling."""
    out = []
    count = sum(p.numel() for p in net.parameters())
    if count != cfg["parameters"]:
        out.append(f"parameters {count} (stated {cfg['parameters']})")
    for name in cfg["decoders"]:
        dec = getattr(net, f"{name}_decoder")
        got = (dec.p5.out_channels, dec.channels, dec.dropout)
        want = (cfg["decoder_pyramid_channels"], cfg["decoder_segmentation_channels"],
                cfg["decoder_dropout"])
        if got != want:
            out.append(f"{name} decoder pyramid, segmentation, dropout {got} (stated {want})")
        head = getattr(net, HEADS[name])
        got = (head[0].out_channels, head.upsampling)
        want = (cfg["head_channels"][name], cfg["head_upsampling"])
        if got != want:
            out.append(f"{HEADS[name]} channels, upsampling {got} (stated {want})")
    return out

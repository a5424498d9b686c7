"""FPN decoder and segmentation head in NCHW with smp's state_dict layout
(counterpart of the JAX package's `models/fpn.py`).

1x1 laterals to 256 channels, nearest x2 top-down adds, per-level
segmentation blocks (conv3x3 + GroupNorm(32, eps 1e-5) + ReLU, with bilinear
x2 upsamples, align_corners=True) down to 128 channels at 1/4 resolution,
'add' merge, channel dropout; the head is a 1x1 conv plus a x4 bilinear
upsample (align_corners=True).

Every convolution computes in the module's `dtype` (`models.conv.Conv2d`,
flax's `nn.Conv(dtype=...)`), as the JAX modules place their casts
(`models/fpn.py:40-185`): GroupNorm normalizes its input cast to float32
and returns float32, so each segmentation block's ReLU and x2 upsamples,
the merge add and the dropout run in float32; the laterals and the
top-down pyramid p2..p5 are in `dtype`, and so are the head's conv, its
bias and its x4 upsample. The bilinear upsample of a float32 map is
`F.interpolate` forward, with JAX's matrix products as its backward; of a
bf16 one, JAX's two products with its align-corners matrices in bf16
(`upsample_bilinear`).

The dropout is flax's `nn.Dropout(broadcast_dims=(1, 2))` of the JAX
decoder (`models/fpn.py:148-152`): in training a [B, C, 1, 1] keep mask
selects whole channels, scaled by 1/(1-p). The mask can be injected (so
that a step can replay another framework's draws); otherwise it is drawn
from the generator given, or from torch's default one.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fastposecnn_tpu_torch.models.conv import Conv2d


@functools.lru_cache(maxsize=16)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] align_corners=True bilinear interpolation matrix, as the
    JAX package builds it: positions in float64, the matrix in float32."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_in == 1:
        m[:, 0] = 1.0
        return m
    pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (pos - lo).astype(np.float32)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return m


@functools.lru_cache(maxsize=32)
def _interp_matrix_on(n_in: int, n_out: int, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    """`_interp_matrix` on `device` in `dtype`, copied there once (a copy
    from pageable host memory waits for the device) and made outside
    inference mode, so that a later training call can save it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(n_in, n_out)).to(device, dtype)


class _InterpolateMatrixBackward(torch.autograd.Function):
    """`F.interpolate`'s bilinear forward; the backward as the transposed
    products with the interpolation matrices, as JAX's is. On CUDA
    `F.interpolate`'s own backward adds with atomics, so two runs of one
    train step differ in every gradient; the products do not."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: int) -> torch.Tensor:
        ctx.scale = scale
        return F.interpolate(x, scale_factor=scale, mode="bilinear",
                             align_corners=True)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h, w = g.shape[-2] // ctx.scale, g.shape[-1] // ctx.scale
        wy = _interp_matrix_on(h, g.shape[-2], g.device, g.dtype)
        wx = _interp_matrix_on(w, g.shape[-1], g.device, g.dtype)
        rows = torch.einsum("pw,bcop->bcow", wx, g)
        return torch.einsum("oh,bcow->bchw", wy, rows), None


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x`scale` upsample with align_corners=True. In bfloat16 the
    JAX package's two products (`models/fpn.py:55-70`): the matrices cast
    to bfloat16, rows first, the intermediate rounded to bfloat16. A
    float32 map takes `F.interpolate` (faster on the card than the
    products, `probes/upsample_paths.py`), with the products' backward
    when a gradient is wanted (reproducible)."""
    if x.dtype != torch.bfloat16:
        if torch.is_grad_enabled() and x.requires_grad:
            return _InterpolateMatrixBackward.apply(x, scale)
        return F.interpolate(x, scale_factor=scale, mode="bilinear",
                             align_corners=True)
    h, w = x.shape[-2:]
    # A program being traced (torch.export) gets constants of its own.
    matrix = (_interp_matrix_on.__wrapped__ if torch.compiler.is_compiling()
              else _interp_matrix_on)
    wy = matrix(h, h * scale, x.device, x.dtype)
    wx = matrix(w, w * scale, x.device, x.dtype)
    rows = torch.einsum("oh,bchw->bcow", wy, x)
    return torch.einsum("pw,bcow->bcop", wx, rows)


class Conv3x3GNReLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, upsample: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.upsample = upsample
        self.block = nn.Sequential(
            Conv2d(in_ch, out_ch, 3, padding=1, bias=False, compute_dtype=dtype),
            nn.GroupNorm(32, out_ch, eps=1e-5),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, gn, relu = self.block
        x = relu(gn(conv(x).to(gn.weight.dtype)))
        return upsample_bilinear(x, 2) if self.upsample else x


class FPNBlock(nn.Module):
    def __init__(self, pyramid_ch: int, skip_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip_conv = Conv2d(skip_ch, pyramid_ch, kernel_size=1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2, mode="nearest") + self.skip_conv(skip)


class SegmentationBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_upsamples: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        blocks = [Conv3x3GNReLU(in_ch, out_ch, upsample=n_upsamples > 0, dtype=dtype)]
        blocks += [Conv3x3GNReLU(out_ch, out_ch, upsample=True, dtype=dtype)
                   for _ in range(1, n_upsamples)]
        self.block = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class FPNDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 pyramid_channels: int = 256,
                 segmentation_channels: int = 128, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c5, c4, c3, c2 = tuple(encoder_channels)[::-1][:4]
        self.p5 = Conv2d(c5, pyramid_channels, kernel_size=1, compute_dtype=dtype)
        self.p4 = FPNBlock(pyramid_channels, c4, dtype)
        self.p3 = FPNBlock(pyramid_channels, c3, dtype)
        self.p2 = FPNBlock(pyramid_channels, c2, dtype)
        self.seg_blocks = nn.ModuleList([
            SegmentationBlock(pyramid_channels, segmentation_channels, n, dtype)
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
    """The 1x1 conv (state_dict key `0.*`) in `dtype`, then the x`upsampling`
    bilinear upsample in `dtype`."""

    def __init__(self, in_ch: int, out_ch: int, upsampling: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__(Conv2d(in_ch, out_ch, kernel_size=1, compute_dtype=dtype))
        self.upsampling = upsampling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x)
        return upsample_bilinear(x, self.upsampling) if self.upsampling > 1 else x

"""Tensor-parallel convolutions (the counterpart of what GSPMD makes of the
JAX package's `shard_state_tp`, `parallel/mesh.py:99-132`).

JAX lays a sharded conv kernel out as P(None, None, None, 'tp') and lets
XLA partition the convolution's output channels and insert the
collectives. Here a sharded convolution is a `TPConv2d` (Megatron's
column-parallel pattern over the tp group of `parallel.mesh`):

  - it holds this rank's contiguous cout / tp rows of the weight (torch's
    [cout, cin, kh, kw], dim 0) and the whole bias, which the rule leaves
    replicated (it is 1-D);
  - its forward computes its slice of the output channels in the
    convolution's compute dtype (`models.conv.Conv2d`: bfloat16 in a bf16
    network), all-gathers them over the tp group in that dtype, then adds
    the bias in it: the ranks of a tp group hold the same batch rows, so
    everything after the gather (BatchNorm, GroupNorm, the heads, the
    pipeline) is computed alike on each, as GSPMD replicates it;
  - its backward takes this rank's slice of the (replicated) output
    gradient, from which the weight's gradient is this rank's slice of the
    whole one; the input's gradient is a partial sum over the tp ranks, so
    the input goes through an identity whose backward all-reduces it over
    the tp group, in the input's dtype (before the cast to the compute
    dtype).

`shard_network_` swaps every shardable `nn.Conv2d` of a network for one,
keeping its compute dtype; `gathered_network` makes a `Conv2d` copy back.
Nothing here falls back: a collective that fails raises.
"""

from __future__ import annotations

import copy
from typing import Set

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from fastposecnn_tpu_torch.models.conv import Conv2d
from fastposecnn_tpu_torch.parallel import mesh


def gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The tp group's tensors concatenated along `dim` in tp order, without
    gradient."""
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(mesh.tp_size())]
    dist.all_gather(parts, t.detach().contiguous(), group=mesh.group("tp"))
    return torch.cat(parts, dim)


def local_slice(t: torch.Tensor, tp: int, index: int) -> torch.Tensor:
    """Rows [index n / tp, (index + 1) n / tp) of `t` (a copy)."""
    n = t.shape[0] // tp
    return t[index * n:(index + 1) * n].detach().clone()


class _CopyToTP(torch.autograd.Function):
    """Identity; the backward sums the input gradient over the tp group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=mesh.group("tp"))
        return g


class _GatherTP(torch.autograd.Function):
    """All-gather of the channels (dim 1) over the tp group; the backward
    takes this rank's slice."""

    @staticmethod
    def forward(ctx, y):
        ctx.index, ctx.local = mesh.tp_rank(), y.shape[1]
        return gather(y, 1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.index * ctx.local, ctx.local).contiguous()


class TPConv2d(nn.Module):
    """An `nn.Conv2d` (groups 1, zero padding) with its output channels
    sharded over the tp group: this rank's rows `index` of `tp` of the
    weight, the whole bias, the whole output, computed in the convolution's
    compute dtype (float32 for a plain `nn.Conv2d`)."""

    def __init__(self, conv: nn.Conv2d, tp: int, index: int):
        super().__init__()
        if conv.groups != 1 or conv.padding_mode != "zeros" or conv.out_channels % tp:
            raise ValueError(f"cannot shard {conv} over {tp} ranks")
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.kernel_size, self.stride = conv.kernel_size, conv.stride
        self.padding, self.dilation = conv.padding, conv.dilation
        self.tp, self.index = tp, index
        self.compute_dtype = getattr(conv, "compute_dtype", torch.float32)
        self.weight = nn.Parameter(local_slice(conv.weight, tp, index),
                                   requires_grad=conv.weight.requires_grad)
        self.weight.tp_sharded = True
        self.bias = (None if conv.bias is None else
                     nn.Parameter(conv.bias.detach().clone(),
                                  requires_grad=conv.bias.requires_grad))

    def __setstate__(self, state):  # a copy or an unpickled module keeps the tag
        super().__setstate__(state)
        self.weight.tp_sharded = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv2d(_CopyToTP.apply(x).to(dt), self.weight.to(dt), None, self.stride,
                     self.padding, self.dilation)
        y = _GatherTP.apply(y)
        return y if self.bias is None else y + self.bias.to(dt)[None, :, None, None]


def is_sharded(p: torch.Tensor) -> bool:
    """Whether `p` is a `TPConv2d`'s weight slice."""
    return getattr(p, "tp_sharded", False)


def shardable(module: nn.Module, tp: int, min_channels: int) -> bool:
    """The JAX rule on a convolution: its output channels divide `tp` and
    number at least `min_channels`."""
    return (type(module) in (nn.Conv2d, Conv2d) and module.out_channels % tp == 0
            and module.out_channels >= min_channels)


def shard_network_(net: nn.Module, tp: int, index: int, min_channels: int) -> Set[str]:
    """Swap each shardable convolution of `net` for a `TPConv2d` holding
    rows `index` of `tp`, in place. Returns the sharded weights' names."""
    sharded = set()
    for name, module in list(net.named_modules()):
        for child_name, child in list(module.named_children()):
            if shardable(child, tp, min_channels):
                setattr(module, child_name, TPConv2d(child, tp, index))
                sharded.add(f"{name}.{child_name}.weight" if name else f"{child_name}.weight")
    return sharded


def sharded_names(net: nn.Module) -> Set[str]:
    return {f"{name}.weight" for name, m in net.named_modules() if isinstance(m, TPConv2d)}


def gathered_network(net: nn.Module) -> nn.Module:
    """A copy of `net` with each `TPConv2d` a `Conv2d` of the gathered weight
    in its compute dtype (a collective over the tp group)."""
    full = copy.deepcopy(net)
    for name, module in list(full.named_modules()):
        for child_name, child in list(module.named_children()):
            if isinstance(child, TPConv2d):
                conv = Conv2d(child.in_channels, child.out_channels, child.kernel_size,
                              child.stride, child.padding, child.dilation,
                              bias=child.bias is not None, device=child.weight.device,
                              compute_dtype=child.compute_dtype)
                with torch.no_grad():
                    conv.weight.copy_(gather(child.weight))
                    if child.bias is not None:
                        conv.bias.copy_(child.bias)
                conv.weight.requires_grad_(child.weight.requires_grad)
                setattr(module, child_name, conv)
    return full

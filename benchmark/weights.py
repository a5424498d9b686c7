"""Seeded random weights, made on the device in a few large calls.

The init families of the JAX package (which the port's
`models/weights.init_random_` copies): the encoder's convolutions
lecun-normal, the decoders' he-uniform, the heads' xavier-uniform; biases
zero; norms unit, BatchNorm running mean 0 and variance 1. The draws are
two calls on a `torch.Generator` of the device, one normal and one
uniform, sliced into the leaves, all float32: the dtype the parameters are
held in (a bfloat16 network casts them where it computes).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from reference.nets import from_config


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state_dict of the network the configuration `cfg` states (the
    port's and the reference's layout) from `seed`, on `device`."""
    with torch.device("meta"):
        skeleton = from_config(cfg)
    normal, uniform = [], []
    for name, mod in skeleton.named_modules():
        if isinstance(mod, nn.Conv2d):
            shape = mod.weight.shape
            fan_in = shape[1] * shape[2] * shape[3]
            fan_out = shape[0] * shape[2] * shape[3]
            if name.startswith("encoder"):
                normal.append((name, shape, 1.0 / math.sqrt(fan_in)))
            else:
                bound = (math.sqrt(6.0 / (fan_in + fan_out)) if "head" in name
                         else math.sqrt(6.0 / fan_in))
                uniform.append((name, shape, bound))
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
    n_total = sum(s.numel() for _, s, _ in normal)
    u_total = sum(s.numel() for _, s, _ in uniform)
    n_draw = torch.randn(n_total, generator=gen, device=device)
    u_draw = torch.rand(u_total, generator=gen, device=device) * 2 - 1
    sd: Dict[str, torch.Tensor] = {}
    for draw, leaves in ((n_draw, normal), (u_draw, uniform)):
        at = 0
        for name, shape, scale in leaves:
            sd[f"{name}.weight"] = draw[at:at + shape.numel()].view(shape) * scale
            at += shape.numel()
    for key, t in skeleton.state_dict().items():
        if key in sd:
            continue
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[key] = torch.zeros((), dtype=torch.int64, device=device)
        elif leaf in ("weight", "running_var"):
            sd[key] = torch.ones(t.shape, device=device)
        else:
            sd[key] = torch.zeros(t.shape, device=device)
    return sd

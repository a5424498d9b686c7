"""Weights for the port's network: conversion of the JAX package's
`{params, batch_stats}` trees (and its npz checkpoints) into this package's
state_dict, and seeded random weights.

Conventions converted (the inverse of the JAX package's
`models/weights.py`):
  flax conv kernel [kh, kw, in, out]  ->  torch Conv2d weight [out, in, kh, kw]
  flax BatchNorm/GroupNorm scale/bias ->  torch weight/bias
  flax batch_stats mean/var           ->  torch running_mean/running_var
The JAX stem kernel is (7, 7, 4, 64) with a zero alpha input channel; its
input channels are sliced to 3. Flax BatchNorm momentum 0.9 is torch
momentum 0.1 (the torch default), which matters only for training.
"""

from __future__ import annotations

import json
import pathlib
import math
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_HEADS = {
    "mask": "segmentation_head",
    "rotation": "rotation_head",
    "translation": "translation_head",
    "scales": "scales_head",
}

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _torch_module(path: str) -> str:
    """flax module path (without the collection and leaf) -> torch module
    path, e.g. 'encoder/layer2_0/downsample_conv' ->
    'encoder.layer2.0.downsample.0'."""
    parts = path.split("/")
    top = parts[0]
    if top == "encoder":
        out = ["encoder"]
        for p in parts[1:]:
            m = re.fullmatch(r"layer(\d)_(\d+)", p)
            if m:
                out += [f"layer{m.group(1)}", m.group(2)]
            elif p == "downsample_conv":
                out += ["downsample", "0"]
            elif p == "downsample_bn":
                out += ["downsample", "1"]
            elif re.fullmatch(r"(conv|bn)\d", p):
                out.append(p)
            else:
                raise KeyError(f"no torch module for flax path '{path}'")
        return ".".join(out)
    m = re.fullmatch(r"(\w+)_decoder", top)
    if m:
        out = [top]
        rest = parts[1:]
        if rest[0] in ("p4", "p3", "p2"):
            return ".".join(out + [rest[0], "skip_conv"])
        if rest[0] == "p5":
            return ".".join(out + ["p5"])
        seg = re.fullmatch(r"seg(\d)", rest[0])
        blk = re.fullmatch(r"block(\d)", rest[1])
        if seg and blk:
            idx = {"conv": "0", "gn": "1"}[rest[2]]
            return ".".join(out + ["seg_blocks", seg.group(1), "block",
                                   blk.group(1), "block", idx])
    m = re.fullmatch(r"(\w+)_head", top)
    if m and parts[1:] == ["conv"]:
        return f"{_HEADS[m.group(1)]}.0"
    raise KeyError(f"no torch module for flax path '{path}'")


def from_jax_params(tree_or_flat: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `{params, batch_stats}` (nested, or flat with 'params/...' and
    'batch_stats/...' keys, as numpy arrays) -> state_dict of
    `PoseRegressorNet`, in float32."""
    flat = _flatten(tree_or_flat)
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        collection, _, rest = key.partition("/")
        if collection not in ("params", "batch_stats"):
            continue
        path, _, leaf = rest.rpartition("/")
        module = _torch_module(path)
        a = np.asarray(arr, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1)  # (kh,kw,in,out) -> (out,in,kh,kw)
            if module == "encoder.conv1":
                a = a[:, :3]  # drop the zero alpha input channel
            name = "weight"
        elif leaf in _BN_LEAVES:
            name = _BN_LEAVES[leaf]
        else:
            raise KeyError(f"unknown flax leaf '{key}'")
        sd[f"{module}.{name}"] = torch.tensor(a)  # a copy, contiguous
        if leaf == "mean":
            sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return sd


def load_npz_checkpoint(path) -> Tuple[Dict[str, np.ndarray], Optional[dict]]:
    """Read a JAX npz weight snapshot with numpy alone.

    Returns (flat arrays keyed 'params/...' and 'batch_stats/...',
    the decoded `__hparams_json__` dict or None)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
        hp = json.loads(str(z["__hparams_json__"])) if "__hparams_json__" in z.files else None
    return flat, hp


@torch.no_grad()
def init_random_(net: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from a seeded generator, in place, with the JAX
    package's init families: convolutions of the encoder lecun-normal,
    decoders he-uniform, heads xavier-uniform; biases zero; norms unit."""
    gen = torch.Generator().manual_seed(seed)
    for name, mod in net.named_modules():
        if isinstance(mod, nn.Conv2d):
            w = mod.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            fan_out = w.shape[0] * w.shape[2] * w.shape[3]
            if name.startswith("encoder"):
                w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
            else:
                bound = (math.sqrt(6.0 / (fan_in + fan_out)) if "head" in name
                         else math.sqrt(6.0 / fan_in))
                w.copy_((torch.rand(w.shape, generator=gen) * 2 - 1) * bound)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    return net


def _npz_hparams(path) -> Optional[dict]:
    """The decoded `__hparams_json__` of an npz snapshot (None if absent),
    read without loading the weights."""
    p = pathlib.Path(path)
    if not (p.is_file() and p.suffix == ".npz"):
        raise NotImplementedError(
            f"{path}: only npz weight snapshots load in this package (orbax "
            "directories and Lightning .ckpt files are not ported)")
    with np.load(p, allow_pickle=False) as z:
        if "__hparams_json__" not in z.files:
            return None
        return json.loads(str(z["__hparams_json__"]))


def merge_arch_from_any(path, hp):
    """The architecture-defining hparams (`config.ARCH_FIELDS`) of an npz
    snapshot merged into `hp`: call before building the dataset and the
    network (counterpart of `train/checkpoint.py::merge_arch_from_any`)."""
    from fastposecnn_tpu_torch import config as C

    ckpt_hp = _npz_hparams(path)
    if ckpt_hp is None:
        return hp
    return C.merge_from_checkpoint(hp, C.HParams.from_json(json.dumps(ckpt_hp)))


def load_any_checkpoint(path, hp):
    """Weights of an npz snapshot as a state_dict of `PoseRegressorNet`, and
    `hp` with the snapshot's architecture fields (the npz half of
    `train/checkpoint.py::load_any_checkpoint`)."""
    hp = merge_arch_from_any(path, hp)
    flat, _ = load_npz_checkpoint(path)
    return from_jax_params(flat), hp

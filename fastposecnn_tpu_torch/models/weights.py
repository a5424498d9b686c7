"""Weights for the port's network: conversion of the JAX package's
`{params, batch_stats}` trees (and its npz checkpoints) into this package's
state_dict and back (`to_jax_flat`), the reference's own torch state_dicts
(`load_state_dict_file`, `convert_reference_state_dict`), and seeded random
weights.

Conventions converted (the inverse of the JAX package's
`models/weights.py`):
  flax conv kernel [kh, kw, in, out]  ->  torch Conv2d weight [out, in, kh, kw]
  flax BatchNorm/GroupNorm scale/bias ->  torch weight/bias
  flax batch_stats mean/var           ->  torch running_mean/running_var
The JAX stem kernel is (7, 7, 4, 64) with a zero alpha input channel; its
input channels are sliced to 3. `models.resnet.BatchNorm` updates the
running statistics as flax does in training.

`from_jax_train_state` carries a whole JAX `TrainState` across: the same
layout rules, applied to every params-shaped tree of the optimizer state
(RAdam's moments, Lookahead's slow weights).

The reference's checkpoints (torchvision ResNet + smp FPN, the layout of
FPC/lib/pose_regressor.py:575-743) already use this package's module
names: after the Lightning `model.` prefix is stripped, the key map is the
identity, and `convert_reference_state_dict` checks that every key is
present, none is extra and every shape agrees.
"""

from __future__ import annotations

import json
import math
import pickle
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


def _flax_module(module: str) -> str:
    """torch module path -> flax module path, the inverse of
    `_torch_module`, e.g. 'encoder.layer2.0.downsample.0' ->
    'encoder/layer2_0/downsample_conv'."""
    parts = module.split(".")
    if parts[0] == "encoder":
        out, rest = ["encoder"], parts[1:]
        while rest:
            p = rest.pop(0)
            if re.fullmatch(r"layer\d", p):
                out.append(f"{p}_{rest.pop(0)}")
            elif p == "downsample":
                out.append({"0": "downsample_conv", "1": "downsample_bn"}[rest.pop(0)])
            else:
                out.append(p)
        return "/".join(out)
    if parts[0].endswith("_decoder"):
        rest = parts[1:]
        if rest[0] in ("p4", "p3", "p2") or rest == ["p5"]:
            return f"{parts[0]}/{rest[0]}"
        if rest[0] == "seg_blocks":  # seg_blocks.i.block.j.block.{0,1}
            kind = {"0": "conv", "1": "gn"}[rest[5]]
            return f"{parts[0]}/seg{rest[1]}/block{rest[3]}/{kind}"
    heads = {v: k for k, v in _HEADS.items()}
    if parts[0] in heads and parts[1:] == ["0"]:
        return f"{heads[parts[0]]}_head/conv"
    raise KeyError(f"no flax module for torch module '{module}'")


def to_jax_flat(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """state_dict of `PoseRegressorNet` -> flat JAX arrays keyed
    'params/<module>/<leaf>' and 'batch_stats/<module>/<leaf>' (float32),
    the layout of the JAX package's npz snapshots: conv weights as kernels
    [kh, kw, in, out], the stem's with its zero alpha input channel
    (7, 7, 4, 64); `num_batches_tracked` has no JAX counterpart."""
    flat: Dict[str, np.ndarray] = {}
    for key, t in state_dict.items():
        module, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        path = _flax_module(module)
        a = t.detach().cpu().float().numpy()
        if leaf == "weight" and a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
            if module == "encoder.conv1":
                a = np.pad(a, ((0, 0), (0, 0), (0, 1), (0, 0)))
            flat[f"params/{path}/kernel"] = a
        elif leaf in ("running_mean", "running_var"):
            flat[f"batch_stats/{path}/{leaf[len('running_'):]}"] = a
        elif leaf in ("weight", "bias"):
            flat[f"params/{path}/{'scale' if leaf == 'weight' else 'bias'}"] = a
        else:
            raise KeyError(f"unknown state_dict entry '{key}'")
    return flat


def load_torch_file(path):
    """`torch.load` on the CPU, tensors only; a Lightning checkpoint whose
    `hyper_parameters` hold other objects (an `argparse.Namespace`) needs
    the full unpickler, which runs only on that refusal (load only
    checkpoints you trust: unpickling can run code)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def load_state_dict_file(path) -> Dict[str, torch.Tensor]:
    """The tensors of a reference torch checkpoint (a plain state_dict, or a
    Lightning `.ckpt` with one under 'state_dict'), with the `model.` prefix
    of the Lightning task module stripped (FPC pose_regressor.py:530)."""
    obj = load_torch_file(path)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in obj.items() if isinstance(v, torch.Tensor)}


def convert_reference_state_dict(state_dict: Mapping[str, torch.Tensor],
                                 net: nn.Module) -> Dict[str, torch.Tensor]:
    """A reference state_dict (prefix stripped) as a state_dict of `net`, in
    its dtypes. Raises KeyError on a missing or an extra key and ValueError
    on a shape that differs."""
    want = net.state_dict()
    missing = sorted(set(want) - set(state_dict))
    extra = sorted(set(state_dict) - set(want))
    if missing or extra:
        raise KeyError(f"reference checkpoint does not fit PoseRegressorNet: "
                       f"missing {missing[:8]}{'...' if len(missing) > 8 else ''}, "
                       f"extra {extra[:8]}{'...' if len(extra) > 8 else ''}")
    out = {}
    for k, t in want.items():
        got = state_dict[k]
        if tuple(got.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(got.shape)}, "
                             f"network {tuple(t.shape)}")
        out[k] = got.detach().to(t.dtype).clone()
    return out


@torch.no_grad()
def init_random_(net: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from a seeded generator, in place, with the JAX
    package's init families: convolutions of the encoder lecun-normal,
    decoders he-uniform, heads xavier-uniform; biases zero but the head
    biases the network was built with (`z_bias_init` on the translation
    head's channels j % 3 == 2, `scales_bias_init` on the scales head's);
    norms unit."""
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
    z_bias = getattr(net, "z_bias_init", 0.0)
    if z_bias:
        net.translation_head[0].bias[2::3] = z_bias
    scales_bias = getattr(net, "scales_bias_init", 0.0)
    if scales_bias:
        net.scales_head[0].bias.fill_(scales_bias)
    return net


def from_jax_train_state(state):
    """A JAX `train/task.py::TrainState` (its arrays as numpy or JAX arrays,
    read through `np.asarray`; no JAX import) -> (state_dict of
    `PoseRegressorNet`, `train.optim.OptState`, step, skipped_updates).

    The JAX optimizer state is `(freeze multipliers,
    InjectHyperparamsState(count, hyperparams={'lr_scale'}, inner_state))`,
    whose inner state holds a `ScaleByAdamState` (count, mu, nu) and a
    `LookaheadState` (slow, step); they are found by their fields."""
    from fastposecnn_tpu_torch.train.optim import OptState

    def params_like(tree):
        return from_jax_params({"params": tree})

    sd = from_jax_params({"params": state.params, "batch_stats": state.batch_stats})
    inject = state.opt_state[1]
    adam = next(s for s in inject.inner_state if hasattr(s, "mu"))
    la = next(s for s in inject.inner_state if hasattr(s, "slow"))
    opt = OptState(mu=params_like(adam.mu), nu=params_like(adam.nu),
                   count=int(np.asarray(adam.count)), slow=params_like(la.slow),
                   lookahead_step=int(np.asarray(la.step)),
                   lr_scale=float(np.asarray(inject.hyperparams["lr_scale"])),
                   hyper_count=int(np.asarray(inject.count)))
    return sd, opt, int(np.asarray(state.step)), int(np.asarray(state.skipped_updates))

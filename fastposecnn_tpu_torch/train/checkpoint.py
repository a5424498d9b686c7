"""Checkpoints with config-travels-with-weights semantics (counterpart of the
JAX package's `train/checkpoint.py`, without orbax).

Three formats load, and the architecture fields of each one's hparams
(`config.ARCH_FIELDS`) override the caller's (`merge_arch_from_any`, called
before the network is built):
  - the port's own full checkpoints: a directory such as
    `checkpoints/last/` of files `step_<step>.pt`, one a step, the newest
    5 kept (`MAX_TO_KEEP`), each holding the state_dict (buffers
    included), the `OptState`, the step, the skipped updates and the
    hparams JSON; written under a temporary name and moved into place with
    `os.replace`. Loading one restores the optimizer too.
  - npz weight snapshots in the JAX package's key layout (`params/...`,
    `batch_stats/...`, `__hparams_json__`), float leaves stored as
    float16, the stem kernel as (7, 7, 4, 64) with its zero alpha input
    channel: each package reads what the other writes.
  - the reference's torch checkpoints (`.ckpt`, `.pth`, `.pt`; a Lightning
    `.ckpt` carries its arch in `hyper_parameters`).
Orbax directories are JAX-only and refused.

A weights-only load (npz or torch) re-derives the optimizer state from the
loaded parameters when given the optimizer: Lookahead's slow weights equal
the loaded parameters and RAdam's moments and count restart at zero. Left
at the template's random weights, the slow weights would pull every fifth
step half way back to them (BASELINE.md:889-904).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fastposecnn_tpu_torch.config import ARCH_FIELDS, HParams, merge_from_checkpoint
from fastposecnn_tpu_torch.models.weights import (
    convert_reference_state_dict,
    from_jax_params,
    load_state_dict_file,
    load_torch_file,
    to_jax_flat,
)
from fastposecnn_tpu_torch.train.optim import OptState
from fastposecnn_tpu_torch.train.task import TrainState

FORMAT = "fastposecnn_tpu_torch/full-checkpoint/1"
MAX_TO_KEEP = 5
_STEP_FILE = re.compile(r"step_(\d+)\.pt")
_HP_KEY = "__hparams_json__"
_TORCH_SUFFIXES = (".ckpt", ".pth", ".pt")


# -----------------------------------------------------------------------------
# Full checkpoints


def _step_files(directory) -> Dict[int, pathlib.Path]:
    d = pathlib.Path(directory)
    if not d.is_dir():
        return {}
    return {int(m.group(1)): p for p in d.iterdir()
            if (m := _STEP_FILE.fullmatch(p.name))}


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def save_checkpoint(directory, step: int, state: TrainState, hp: HParams) -> pathlib.Path:
    """Write `state` (its own step count included) as
    `directory/step_<step>.pt` and keep the newest `MAX_TO_KEEP` steps.
    Returns the file's path."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    opt = state.opt_state
    payload = {
        "format": FORMAT,
        "state_dict": _cpu(state.net.state_dict()),
        "opt_state": {"mu": _cpu(opt.mu), "nu": _cpu(opt.nu), "count": int(opt.count),
                      "slow": _cpu(opt.slow), "lookahead_step": int(opt.lookahead_step),
                      "lr_scale": float(opt.lr_scale), "hyper_count": int(opt.hyper_count)},
        "step": int(state.step),
        "skipped_updates": int(state.skipped_updates),
        "hparams_json": hp.to_json(),
    }
    path = d / f"step_{int(step):08d}.pt"
    tmp = d / f".{path.name}.part"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    steps = _step_files(d)
    for old in sorted(steps)[:-MAX_TO_KEEP]:
        steps[old].unlink()
    return path


def latest_step(directory) -> Optional[int]:
    steps = _step_files(directory)
    return max(steps) if steps else None


def _is_full_payload(obj) -> bool:
    return isinstance(obj, dict) and obj.get("format") == FORMAT


def _full_checkpoint_file(path, step: Optional[int] = None) -> Optional[pathlib.Path]:
    """The file of a full checkpoint: `path` itself, or the file of `step`
    (default the latest) in the directory `path`; None if `path` is none."""
    p = pathlib.Path(path)
    if p.is_dir():
        steps = _step_files(p)
        if not steps:
            return None
        return steps[max(steps) if step is None else step]
    if p.is_file() and _STEP_FILE.fullmatch(p.name) and _is_full_payload(load_torch_file(p)):
        return p
    return None


def load_checkpoint(path, state: TrainState, hp: HParams, step: Optional[int] = None
                    ) -> Tuple[TrainState, HParams]:
    """Restore a full checkpoint (a `step_<n>.pt` file, or a directory of
    them at `step`, default the latest) into `state`'s network, in place, and
    its optimizer state on the network's device. Returns (state, `hp` with
    the checkpoint's arch fields)."""
    f = _full_checkpoint_file(path, step)
    if f is None:
        raise FileNotFoundError(f"{path}: no full checkpoint (step_<n>.pt) there")
    payload = torch.load(f, map_location="cpu", weights_only=True)
    hp = merge_from_checkpoint(hp, HParams.from_json(payload["hparams_json"]))
    state.net.load_state_dict(payload["state_dict"])
    dev = next(state.net.parameters()).device
    o = payload["opt_state"]

    def on_dev(tensors):
        return {k: v.to(dev) for k, v in tensors.items()}

    opt = OptState(mu=on_dev(o["mu"]), nu=on_dev(o["nu"]), count=o["count"],
                   slow=on_dev(o["slow"]), lookahead_step=o["lookahead_step"],
                   lr_scale=o["lr_scale"], hyper_count=o["hyper_count"])
    return TrainState(state.net, opt, payload["step"], payload["skipped_updates"]), hp


# -----------------------------------------------------------------------------
# npz weight snapshots, in the JAX package's layout


def is_npz_snapshot(path) -> bool:
    p = pathlib.Path(path)
    return p.is_file() and p.suffix == ".npz"


def save_npz_snapshot(path, state: TrainState, hp: HParams) -> None:
    """params + batch_stats of `state` as float16 leaves under their JAX keys,
    and the hparams JSON; written as `<path>.part`, then moved into place."""
    arrays = {k: a.astype(np.float16) for k, a in to_jax_flat(state.net.state_dict()).items()}
    arrays[_HP_KEY] = np.array(hp.to_json())
    tmp = pathlib.Path(str(path) + ".part")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def _npz_state_dict(path, net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A snapshot's arrays as a state_dict of `net`, every key and shape
    checked against the network's own JAX layout."""
    want = to_jax_flat(net.state_dict())
    with np.load(path, allow_pickle=False) as data:
        got = {k: data[k] for k in data.files if not k.startswith("__")}
    for key, a in want.items():
        if key not in got:
            raise KeyError(f"snapshot {path} is missing {key!r}: architecture mismatch "
                           "(check ENCODER/num_classes hparams)")
        if got[key].shape != a.shape:
            raise ValueError(f"snapshot {path}: {key!r} has shape {got[key].shape}, the "
                             f"network expects {a.shape}: architecture mismatch")
    extra = sorted(set(got) - set(want))
    if extra:
        raise KeyError(f"snapshot {path} holds keys the network lacks: {extra[:8]}")
    return from_jax_params(got)


def load_npz_snapshot(path, state: TrainState, hp: HParams) -> Tuple[TrainState, HParams]:
    """Restore params + batch_stats from a snapshot into `state`'s network,
    in place; the optimizer state is left as it is."""
    hp = merge_arch_from_any(path, hp)
    state.net.load_state_dict(_npz_state_dict(path, state.net))
    return state, hp


# -----------------------------------------------------------------------------
# Reference (torch/Lightning) checkpoints


def is_torch_checkpoint(path) -> bool:
    p = pathlib.Path(path)
    return p.is_file() and p.suffix in _TORCH_SUFFIXES


def _torch_hyper_parameters(path) -> dict:
    """The 'hyper_parameters' a Lightning checkpoint stores
    (FPC/lib/pose_regressor.py:518), as a dict (a Namespace is unpacked)."""
    obj = load_torch_file(path)
    if not isinstance(obj, dict):
        return {}
    old = obj.get("hyper_parameters", {})
    if not isinstance(old, dict):
        old = vars(old) if hasattr(old, "__dict__") else {}
    return old


def _refuse_directory(path):
    raise NotImplementedError(
        f"{path}: a directory without step_<n>.pt files. Orbax checkpoint "
        "directories are JAX-only and do not load in fastposecnn_tpu_torch; "
        "write an npz snapshot with the JAX package's "
        "train/checkpoint.py::save_npz_snapshot and pass that instead")


def merge_arch_from_any(path, hp: HParams) -> HParams:
    """`hp` with the architecture fields of any checkpoint this module loads:
    call before building the network, as the reference's load_from_ckpt
    does (FPC/lib/pose_regressor.py:516-525)."""
    p = pathlib.Path(path)
    if is_npz_snapshot(p):
        with np.load(p, allow_pickle=False) as data:
            if _HP_KEY not in data.files:
                return hp
            return merge_from_checkpoint(hp, HParams.from_json(str(data[_HP_KEY])))
    full = _full_checkpoint_file(p)
    if full is not None:
        payload = torch.load(full, map_location="cpu", weights_only=True)
        return merge_from_checkpoint(hp, HParams.from_json(payload["hparams_json"]))
    if p.is_dir():
        _refuse_directory(p)
    if is_torch_checkpoint(p):
        old = _torch_hyper_parameters(p)
        updates = {}
        for k in ARCH_FIELDS:
            if old.get(k) is not None:
                v = old[k]
                updates[k] = tuple(v) if isinstance(v, (list, tuple)) else v
        return dataclasses.replace(hp, **updates)
    raise FileNotFoundError(f"{path}: not a checkpoint this package loads (a directory "
                            "of step_<n>.pt files, an .npz snapshot or a torch "
                            ".ckpt/.pth/.pt file)")


def load_weights(net: torch.nn.Module, path, hp: HParams) -> HParams:
    """Load only the weights (parameters and BatchNorm statistics) of any
    checkpoint this module reads into `net`, in place. Returns `hp` with the
    checkpoint's arch fields; build `net` from `merge_arch_from_any` first."""
    hp = merge_arch_from_any(path, hp)
    full = _full_checkpoint_file(path)
    if full is not None:
        net.load_state_dict(torch.load(full, map_location="cpu",
                                       weights_only=True)["state_dict"])
    elif is_npz_snapshot(path):
        net.load_state_dict(_npz_state_dict(path, net))
    else:
        net.load_state_dict(convert_reference_state_dict(load_state_dict_file(path), net))
    return hp


def load_any_checkpoint(path, state: TrainState, hp: HParams, step: Optional[int] = None,
                        optimizer=None) -> Tuple[TrainState, HParams]:
    """Restore a full checkpoint (optimizer included), or the weights of an
    npz snapshot or a reference torch checkpoint. After a weights-only load
    the optimizer state is re-derived from the loaded parameters when
    `optimizer` is given (required to resume training from such a file)."""
    if _full_checkpoint_file(path, step) is not None:
        return load_checkpoint(path, state, hp, step=step)
    hp = load_weights(state.net, path, hp)
    if optimizer is not None:
        state = dataclasses.replace(
            state, opt_state=optimizer.init(dict(state.net.named_parameters())))
    return state, hp


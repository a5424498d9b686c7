"""The optimizer: RAdam + Lookahead, global-norm clip, freezing, the
encoder's learning-rate ratio and the plateau scale (counterpart of the
JAX package's `train/optim.py`), as explicit transforms over dicts of
tensors keyed by parameter name (`net.named_parameters()`).

The chain, in the order of the JAX `make_optimizer` (:163-192):
  1. freeze: x0 on the gradients of frozen modules (before the clip, so
     frozen gradients do not count in its norm);
  2. clip by global norm (GRADIENT_CLIP_VAL; of the whole gradients when
     the state is tp-sharded, `global_norm`);
  3. RAdam scaling, optax's `scale_by_radam` defaults (b1 0.9, b2 0.999,
     eps 1e-8, threshold 5);
  4. decoupled weight decay: + WEIGHT_DECAY * param;
  5. per-module ratio: 0 frozen, ENCODER_LEARNING_RATE / LEARNING_RATE on
     the encoder, 1 elsewhere;
  6. x(-LEARNING_RATE);
  7. x lr_scale (the plateau scale, `set_lr_scale`);
  8. Lookahead (sync every 5 steps, slow step 0.5).
`torch.optim.RAdam` is not used: it adds the weight decay to the gradient
and rectifies from another formula. Every step but the clip is
elementwise, so it acts on a tp-sharded state's slices as they are.

The step's scalars (bias corrections, RAdam's rectification) come from the
host's step count, in float64, and are rounded to float32 where optax
rounds them; as optax computes them under `jax_enable_x64`. Without x64
optax rounds them in float32, which moves the rectification term by up to
about 1% near its threshold.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from fastposecnn_tpu_torch.parallel import mesh
from fastposecnn_tpu_torch.parallel.tp import is_sharded

Params = Dict[str, torch.Tensor]

B1, B2, EPS, RADAM_THRESHOLD = 0.9, 0.999, 1e-8, 5.0
LOOKAHEAD_SYNC, LOOKAHEAD_ALPHA = 5, 0.5

# Top-level modules of `PoseRegressorNet` frozen by each FREEZE_* flag.
_FREEZE_GROUPS = {
    "FREEZE_ENCODER": ("encoder",),
    "FREEZE_MASK_TRAINING": ("mask_decoder", "segmentation_head"),
    "FREEZE_ROTATION_TRAINING": ("rotation_decoder", "rotation_head"),
    "FREEZE_TRANSLATION_TRAINING": ("translation_decoder", "translation_head"),
    "FREEZE_SCALES_TRAINING": ("scales_decoder", "scales_head"),
}


def _f32(x: float) -> float:
    return float(np.float32(x))


# -----------------------------------------------------------------------------
# The transforms


def global_norm(tensors: List[torch.Tensor],
                sharded: Sequence[bool] = ()) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a device scalar). A
    tensor flagged in `sharded` is this rank's slice of a tp-sharded one
    (`parallel.tp`): its squares are summed over the tp group, and a
    replicated tensor counts once."""
    if not any(sharded):
        return torch.sqrt(sum((t * t).sum() for t in tensors))
    own = [(t * t).sum() for t, s in zip(tensors, sharded, strict=True) if s]
    rest = [(t * t).sum() for t, s in zip(tensors, sharded) if not s]
    return torch.sqrt(sum(rest) + mesh.global_sum(sum(own), over="tp"))


def clip_by_global_norm(updates: List[torch.Tensor], max_norm: float,
                        sharded: Sequence[bool] = ()) -> List[torch.Tensor]:
    """optax's `clip_by_global_norm`: unchanged below `max_norm`, else
    (t / norm) * max_norm. Decided on the device, with no host sync.
    `sharded` as for `global_norm`."""
    norm = global_norm(updates, sharded)
    keep = norm < max_norm
    return [torch.where(keep, t, (t / norm) * max_norm) for t in updates]


def radam_scalars(count: int) -> Dict[str, float]:
    """RAdam's per-step scalars at the step count `count` (already
    incremented): the two bias corrections (float32), whether the update
    is rectified, and the rectification term (float32)."""
    ro_inf = 2.0 / (1.0 - B2) - 1.0
    b2t = B2 ** count
    ro = ro_inf - 2 * count * b2t / (1 - b2t)
    out = {"bc1": _f32(1 - B1 ** count), "bc2": _f32(1 - b2t),
           "rectified": ro >= RADAM_THRESHOLD, "r": 1.0}
    if out["rectified"]:
        out["r"] = _f32(math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)))
    return out


def scale_by_radam(updates: List[torch.Tensor], mu: List[torch.Tensor],
                   nu: List[torch.Tensor], count: int):
    """optax's `scale_by_radam` with its defaults. `count` is the step count
    before this update. Returns (updates, mu, nu, count + 1)."""
    count += 1
    mu = torch._foreach_add(torch._foreach_mul(updates, 1 - B1),
                            torch._foreach_mul(mu, B1))
    sq = torch._foreach_mul(updates, updates)
    nu = torch._foreach_add(torch._foreach_mul(sq, 1 - B2),
                            torch._foreach_mul(nu, B2))
    s = radam_scalars(count)
    mu_hat = torch._foreach_div(mu, s["bc1"])
    if not s["rectified"]:
        return mu_hat, mu, nu, count
    nu_hat = torch._foreach_div(nu, s["bc2"])
    denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS)
    return (torch._foreach_div(torch._foreach_mul(mu_hat, s["r"]), denom),
            mu, nu, count)


def add_decayed_weights(updates: List[torch.Tensor], params: List[torch.Tensor],
                        weight_decay: float) -> List[torch.Tensor]:
    return torch._foreach_add(updates, torch._foreach_mul(params, weight_decay))


def scale_each(updates: List[torch.Tensor],
               multipliers: List[float]) -> List[torch.Tensor]:
    return torch._foreach_mul(updates, multipliers)


def lookahead(updates: List[torch.Tensor], params: List[torch.Tensor],
              slow: List[torch.Tensor], step: int,
              sync_period: int = LOOKAHEAD_SYNC,
              slow_step_size: float = LOOKAHEAD_ALPHA):
    """The JAX package's `lookahead`: tracks the fast weights p + u and,
    every `sync_period` steps, moves the slow weights half way to them and
    lands the parameters there. Returns (updates, slow, step + 1)."""
    step += 1
    fast = torch._foreach_add(params, updates)
    if step % sync_period:
        return torch._foreach_sub(fast, params), slow, step
    diff = torch._foreach_sub(fast, slow)
    slow = torch._foreach_add(slow, torch._foreach_mul(diff, slow_step_size))
    return torch._foreach_sub(slow, params), slow, step


# -----------------------------------------------------------------------------
# The chain


def frozen_modules(hp) -> set:
    return {m for flag, mods in _FREEZE_GROUPS.items() if getattr(hp, flag)
            for m in mods}


def module_multipliers(hp, names: List[str], ratio: bool = True) -> List[float]:
    """Per-parameter multiplier: 0 in a frozen module; the encoder's
    ENCODER_LEARNING_RATE / LEARNING_RATE (`ratio=True`); 1 otherwise."""
    frozen = frozen_modules(hp)
    enc = (hp.ENCODER_LEARNING_RATE / hp.LEARNING_RATE
           if ratio and hp.LEARNING_RATE > 0 else 1.0)
    out = []
    for name in names:
        top = name.split(".", 1)[0]
        out.append(0.0 if top in frozen else _f32(enc) if top == "encoder" else 1.0)
    return out


@dataclasses.dataclass
class OptState:
    """The optimizer's state: RAdam's moments and count, Lookahead's slow
    weights and step, the injected plateau scale and its wrapper's update
    count. Moments and slow weights are keyed by parameter name."""
    mu: Params
    nu: Params
    count: int
    slow: Params
    lookahead_step: int
    lr_scale: float = 1.0
    hyper_count: int = 0


class Optimizer:
    """`make_optimizer`'s chain for parameters named `names`."""

    def __init__(self, hp, names: List[str]):
        self.names = list(names)
        self.clip = hp.GRADIENT_CLIP_VAL
        self.weight_decay = hp.WEIGHT_DECAY
        self.lr = hp.LEARNING_RATE
        self.freeze = module_multipliers(hp, self.names, ratio=False)
        self.ratio = module_multipliers(hp, self.names, ratio=True)

    def init(self, params: Params) -> OptState:
        zeros = {n: torch.zeros_like(params[n]) for n in self.names}
        return OptState(mu=zeros, nu={n: z.clone() for n, z in zeros.items()},
                        count=0, slow={n: params[n].detach().clone() for n in self.names},
                        lookahead_step=0)

    def update(self, grads: Params, state: OptState, params: Params):
        """(updates, new state) for the gradients `grads`."""
        ps = [params[n].detach() for n in self.names]
        u = scale_each([grads[n] for n in self.names], self.freeze)
        u = clip_by_global_norm(u, self.clip, [is_sharded(params[n]) for n in self.names])
        u, mu, nu, count = scale_by_radam(
            u, [state.mu[n] for n in self.names], [state.nu[n] for n in self.names],
            state.count)
        u = add_decayed_weights(u, ps, self.weight_decay)
        u = scale_each(u, self.ratio)
        u = torch._foreach_mul(u, -self.lr)
        u = torch._foreach_mul(u, _f32(state.lr_scale))
        u, slow, la_step = lookahead(u, ps, [state.slow[n] for n in self.names],
                                     state.lookahead_step)
        new = OptState(mu=dict(zip(self.names, mu)), nu=dict(zip(self.names, nu)),
                       count=count, slow=dict(zip(self.names, slow)),
                       lookahead_step=la_step, lr_scale=state.lr_scale,
                       hyper_count=state.hyper_count + 1)
        return dict(zip(self.names, u)), new


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """p <- p + u, in place."""
    names = list(updates)
    torch._foreach_add_([params[n] for n in names], [updates[n] for n in names])


def set_lr_scale(state: OptState, scale: float) -> OptState:
    """Write the plateau scale into the optimizer state (float32)."""
    return dataclasses.replace(state, lr_scale=_f32(scale))


# -----------------------------------------------------------------------------
# ReduceLROnPlateau on a validation metric


@dataclasses.dataclass(frozen=True)
class PlateauState:
    scale: float
    best: float
    bad_epochs: int


def plateau_init() -> PlateauState:
    return PlateauState(scale=1.0, best=math.inf, bad_epochs=0)


def plateau_update(state: PlateauState, metric: float, patience: int = 2,
                   factor: float = 0.25, min_scale: float = 1e-4,
                   ) -> PlateauState:
    """ReduceLROnPlateau: after more than `patience` epochs without a new
    best, scale *= factor (not below `min_scale`) and the count restarts."""
    metric = float(metric)
    bad = 0 if metric < state.best else state.bad_epochs + 1
    trigger = bad > patience
    return PlateauState(
        scale=max(state.scale * factor, min_scale) if trigger else state.scale,
        best=min(state.best, metric),
        bad_epochs=0 if trigger else bad)


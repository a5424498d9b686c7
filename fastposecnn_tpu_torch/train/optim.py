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

On CUDA the step's gradient-to-parameter path is kernel K3
(`kernels/optim.cu`), two launches whatever the number of tensors:
`Optimizer.grad_stats` launches K3a (each gradient's sum of squares of
`nan_to_num(g)` and the count of non-finite elements, from which the
logged norm, the clip's norm and the finite flag come), and
`apply_updates` launches K3b, which `Optimizer.update` hands back deferred:
the whole chain elementwise, writing the parameters, RAdam's moments and
Lookahead's slow weights in place. The foreach chain above is K3b's plain
version (`Optimizer.plain_update`), which CPU tensors take; given the same
clip norm K3b is bit-equal to it, and only the norms' order of summation
differs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fastposecnn_tpu_torch.kernels import count_launch
from fastposecnn_tpu_torch.kernels.build import check, load_library
from fastposecnn_tpu_torch.parallel import mesh
from fastposecnn_tpu_torch.parallel.tp import is_sharded

Params = Dict[str, torch.Tensor]
Grads = Dict[str, Optional[torch.Tensor]]

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


def norm_of_squares(squares: List[torch.Tensor],
                    sharded: Sequence[bool] = ()) -> torch.Tensor:
    """sqrt of the sum of per-tensor sums of squares (device scalars), added
    in order. A tensor flagged in `sharded` is this rank's slice of a
    tp-sharded one (`parallel.tp`): its squares are summed over the tp
    group, and a replicated tensor counts once."""
    if not any(sharded):
        return torch.sqrt(sum(squares))
    own = [q for q, s in zip(squares, sharded, strict=True) if s]
    rest = [q for q, s in zip(squares, sharded) if not s]
    return torch.sqrt(sum(rest) + mesh.global_sum(sum(own), over="tp"))


def global_norm(tensors: List[torch.Tensor],
                sharded: Sequence[bool] = ()) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a device scalar);
    `sharded` as for `norm_of_squares`."""
    return norm_of_squares([(t * t).sum() for t in tensors], sharded)


def clip_by_global_norm(updates: List[torch.Tensor], max_norm: float,
                        sharded: Sequence[bool] = (),
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """optax's `clip_by_global_norm`: unchanged below `max_norm`, else
    (t / norm) * max_norm. Decided on the device, with no host sync.
    `sharded` as for `global_norm`; `norm`, when given, is the updates'
    global norm, computed elsewhere (`GradStats.clip_norm`)."""
    if norm is None:
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
    count. Moments and slow weights are keyed by parameter name. On CUDA an
    update writes the moments and slow weights in place (K3b), so the state
    an update returns holds the same tensors as the one it was given, and a
    state kept past a step must be cloned (`train/staged.py::clone_state`);
    on the CPU an update returns new tensors."""
    mu: Params
    nu: Params
    count: int
    slow: Params
    lookahead_step: int
    lr_scale: float = 1.0
    hyper_count: int = 0


@dataclasses.dataclass
class GradStats:
    """What a step needs of its gradients before the update (K3a, or its
    plain version): whether every element is finite, the logged global norm
    of `nan_to_num(g)` before freezing, the clip's norm (the same without
    the frozen tensors), the count of non-finite elements and each tensor's
    sum of squares [N], in the optimizer's order. All on the device."""
    finite: torch.Tensor
    norm: torch.Tensor
    clip_norm: torch.Tensor
    nonfinite: torch.Tensor
    sums: torch.Tensor


def grad_stats_plain(grads: List[Optional[torch.Tensor]], freeze: Sequence[float],
                     sharded: Sequence[bool], device) -> GradStats:
    """K3a's plain version, a few ops a tensor. A missing gradient (None)
    reads as zeros. The norms add the per-tensor sums in order, as
    `global_norm` does, so they are bit-equal to `global_norm` of the
    `nan_to_num` gradients (the logged norm) and of those gradients times
    `freeze` (the clip's)."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    safe = [None if g is None else torch.nan_to_num(g) for g in grads]
    squares = [zero if t is None else (t * t).sum() for t in safe]
    bad = [(~torch.isfinite(g)).sum() for g in grads if g is not None]
    nonfinite = torch.stack(bad).sum() if bad else zero.long()
    live = [f != 0 for f in freeze]
    clip_norm = norm_of_squares([q for q, keep in zip(squares, live) if keep],
                                [s for s, keep in zip(sharded, live) if keep]) if any(live) \
        else zero
    return GradStats(finite=nonfinite == 0, norm=norm_of_squares(squares, sharded),
                     clip_norm=clip_norm, nonfinite=nonfinite, sums=torch.stack(squares))


class Optimizer:
    """`make_optimizer`'s chain for parameters named `names`. On CUDA
    tensors `grad_stats` and `update` go to kernel K3, on CPU tensors to
    their plain versions."""

    def __init__(self, hp, names: List[str]):
        self.names = list(names)
        self.clip = hp.GRADIENT_CLIP_VAL
        self.weight_decay = hp.WEIGHT_DECAY
        self.lr = hp.LEARNING_RATE
        self.freeze = module_multipliers(hp, self.names, ratio=False)
        self.ratio = module_multipliers(hp, self.names, ratio=True)
        self._table: Optional[K3Table] = None

    def init(self, params: Params) -> OptState:
        zeros = {n: torch.zeros_like(params[n]) for n in self.names}
        return OptState(mu=zeros, nu={n: z.clone() for n, z in zeros.items()},
                        count=0, slow={n: params[n].detach().clone() for n in self.names},
                        lookahead_step=0)

    def grad_stats(self, grads: Grads, state: OptState, params: Params) -> GradStats:
        """The gradients' `GradStats` (K3a on CUDA)."""
        gs = [grads[n] for n in self.names]
        if params[self.names[0]].device.type != "cuda":
            return grad_stats_plain(gs, self.freeze, [is_sharded(params[n]) for n in self.names],
                                    params[self.names[0]].device)
        table = self.k3_table(state, params)
        table.upload_grads(gs)
        return grad_stats_cuda(table)

    def update(self, grads: Grads, state: OptState, params: Params,
               clip_norm: Optional[torch.Tensor] = None):
        """(updates, new state) for the gradients `grads` (a missing one,
        None, reads as zeros). `clip_norm` is the clip's norm from
        `grad_stats`; on the CPU the update computes it when it is not
        given, on CUDA it is required. On CUDA the updates are K3b's
        launch, deferred until `apply_updates`, which writes the
        parameters, moments and slow weights in place."""
        if params[self.names[0]].device.type != "cuda":
            return self.plain_update(grads, state, params, clip_norm)
        if clip_norm is None:
            raise ValueError("K3: on CUDA the update takes the clip norm of `grad_stats`")
        table = self.k3_table(state, params)
        table.upload_grads([grads[n] for n in self.names])
        count, step = state.count + 1, state.lookahead_step + 1
        s = radam_scalars(count)
        scalars = StepScalars(
            one_minus_b1=_f32(1 - B1), b1=_f32(B1), one_minus_b2=_f32(1 - B2), b2=_f32(B2),
            inv_bc1=_reciprocal(s["bc1"]), inv_bc2=_reciprocal(s["bc2"]), r=s["r"],
            eps=_f32(EPS),
            weight_decay=_f32(self.weight_decay), neg_lr=_f32(-self.lr),
            lr_scale=_f32(state.lr_scale), max_norm=_f32(self.clip),
            slow_step=_f32(LOOKAHEAD_ALPHA), rectified=int(s["rectified"]),
            sync=int(step % LOOKAHEAD_SYNC == 0))
        new = dataclasses.replace(state, count=count, lookahead_step=step,
                                  hyper_count=state.hyper_count + 1)
        return FusedUpdate(table, scalars, clip_norm), new

    def k3_table(self, state: OptState, params: Params) -> "K3Table":
        """K3's table for these parameters, moments and slow weights: the
        last one while their addresses and sizes stay, else a new one (a
        restored checkpoint, a tp-sharded or a cloned state)."""
        groups = {"params": [params[n] for n in self.names],
                  "mu": [state.mu[n] for n in self.names],
                  "nu": [state.nu[n] for n in self.names],
                  "slow": [state.slow[n] for n in self.names]}
        key = (tuple(t.data_ptr() for ts in groups.values() for t in ts),
               tuple(p.numel() for p in groups["params"]))
        if self._table is None or self._table.key != key:
            self._table = K3Table(self, groups, [is_sharded(p) for p in groups["params"]], key)
        return self._table

    def plain_update(self, grads: Grads, state: OptState, params: Params,
                     clip_norm: Optional[torch.Tensor] = None):
        """The foreach chain: K3b's plain version, on any device."""
        ps = [params[n].detach() for n in self.names]
        gs = [torch.zeros_like(p) if grads[n] is None else grads[n]
              for n, p in zip(self.names, ps)]
        u = scale_each(gs, self.freeze)
        u = clip_by_global_norm(u, self.clip, [is_sharded(params[n]) for n in self.names],
                                norm=clip_norm)
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
def apply_updates(params: Params, updates) -> None:
    """p <- p + u, in place. Updates from a CUDA `Optimizer.update` are
    K3b's deferred launch: it runs here and also writes RAdam's moments
    and, on a Lookahead sync, the slow weights."""
    if isinstance(updates, FusedUpdate):
        updates.launch()
        return
    names = list(updates)
    torch._foreach_add_([params[n] for n in names], [updates[n] for n in names])


# -----------------------------------------------------------------------------
# K3 on CUDA: the table of tensors and the launches

CHUNK = 16384  # elements a block of K3a or K3b takes


def chunk_map(numels: Sequence[int], chunk: int = CHUNK) -> Tuple[np.ndarray, np.ndarray]:
    """K3's blocks over tensors of `numels` elements: (the first chunk of
    each tensor, N + 1 entries, the last the number of chunks; the tensor of
    each chunk). A tensor has ceil(numel / chunk) chunks, and one if it is
    empty, so that every tensor gets a block."""
    counts = np.array([max(1, -(-int(n) // chunk)) for n in numels], np.int64)
    first = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return first, np.repeat(np.arange(len(counts), dtype=np.int64), counts)


def build_table(pointers: Sequence[Sequence[int]], numels: Sequence[int],
                freeze: Sequence[float], ratio: Sequence[float], sharded: Sequence[bool],
                chunk: int = CHUNK) -> Tuple[np.ndarray, np.ndarray]:
    """K3's table, as host arrays (the layout `kernels/optim.cu` reads).
    `pointers` holds four lists (parameters, mu, nu, slow) of N addresses.
    Returns the int64 words [param, mu, nu, slow pointers (N each) | numel
    (N) | first chunk of each tensor (N + 1) | the tensor of each chunk] and
    the float32 multipliers [freeze (N) | ratio (N) | sharded (N, 0 or 1)]."""
    n = len(numels)
    if len(pointers) != 4 or any(len(ps) != n for ps in pointers) or not (
            len(freeze) == len(ratio) == len(sharded) == n):
        raise ValueError("build_table: four lists of pointers and per-tensor "
                         f"values for each of the {n} tensors")
    first, owner = chunk_map(numels, chunk)
    words = np.concatenate([np.array(ps, np.uint64).view(np.int64) for ps in pointers]
                           + [np.array(numels, np.int64), first, owner])
    mult = np.array(list(freeze) + list(ratio) + [float(s) for s in sharded], np.float32)
    return words, mult


def check_k3_tensors(groups: Dict[str, Sequence[torch.Tensor]],
                     numels: Sequence[int], device: torch.device) -> None:
    """Raise unless every tensor is contiguous float32 on `device` and the
    i-th tensor of every group has numels[i] elements."""
    for what, ts in groups.items():
        for i, t in enumerate(ts):
            if (t.dtype != torch.float32 or t.device != device or not t.is_contiguous()
                    or t.numel() != numels[i]):
                raise ValueError(
                    f"K3: {what}[{i}] must be a contiguous float32 tensor of "
                    f"{numels[i]} elements on {device}, got {t.dtype} "
                    f"{tuple(t.shape)} (contiguous {t.is_contiguous()}) on {t.device}")


class StepScalars(ctypes.Structure):
    """K3b's step scalars (`FpcnnOptimStep` in `kernels/optim.cu`), each
    already rounded to float32 as PyTorch rounds a Python scalar."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "one_minus_b1", "b1", "one_minus_b2", "b2", "inv_bc1", "inv_bc2", "r", "eps",
        "weight_decay", "neg_lr", "lr_scale", "max_norm", "slow_step")] + [
        ("rectified", ctypes.c_int), ("sync", ctypes.c_int)]


def _reciprocal(x: float) -> float:
    """1 / x in float32, the factor by which PyTorch's CUDA foreach ops
    multiply where they divide by the scalar x (for every bias correction a
    run can reach, the float32 quotient equals the float64 one rounded)."""
    return float(np.float32(1.0) / np.float32(x))


def _pinned(a: np.ndarray) -> torch.Tensor:
    """A host array in pinned memory, to be copied to the device without a
    host sync (`non_blocking=True`). PyTorch's caching host allocator
    records such a copy on the pinned block and hands the block out again
    only once the copy is done, so the host tensor may be dropped at once:
    no buffer is rewritten while a copy from it is in flight."""
    return torch.from_numpy(a).pin_memory()


class K3Table:
    """K3's table on the device for one set of parameters, moments and slow
    weights (`key`: their addresses and sizes), with its scratch: the
    per-block partials, the ticket counter and the gradients' pointers. The
    table is uploaded once; the gradients' pointers go up again only when
    they change."""

    def __init__(self, opt: "Optimizer", groups: Dict[str, List[torch.Tensor]],
                 sharded: List[bool], key: tuple):
        ps = groups["params"]
        self.key = key
        self.device = ps[0].device
        self.numels = [p.numel() for p in ps]
        if self.device.type != "cuda":
            raise ValueError(f"K3 runs on CUDA tensors, got {self.device}")
        check_k3_tensors(groups, self.numels, self.device)
        words, mult = build_table([[t.data_ptr() for t in groups[k]] for k in groups],
                                  self.numels, opt.freeze, opt.ratio, sharded)
        self.n, self.n_chunks = len(ps), len(words) - 6 * len(ps) - 1
        self.any_sharded = any(sharded)
        self.words = _pinned(words).to(self.device, non_blocking=True)
        self.mult = _pinned(mult).to(self.device, non_blocking=True)
        self.partial = torch.empty(self.n_chunks, dtype=torch.float64, device=self.device)
        self.partial_bad = torch.empty(self.n_chunks, dtype=torch.int32, device=self.device)
        self.done = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.grads = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        self._grad_ptrs: Optional[Tuple[int, ...]] = None

    def upload_grads(self, grads: List[Optional[torch.Tensor]]) -> None:
        """Point the table at this step's gradients (None: zeros). Checked
        and copied only when their addresses change."""
        ptrs = tuple(0 if g is None else g.data_ptr() for g in grads)
        if ptrs == self._grad_ptrs:
            return
        present = [i for i, g in enumerate(grads) if g is not None]
        check_k3_tensors({"grads": [grads[i] for i in present]},
                         [self.numels[i] for i in present], self.device)
        self.grads.copy_(_pinned(np.array(ptrs, np.uint64).view(np.int64)), non_blocking=True)
        self._grad_ptrs = ptrs

    def stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream


def grad_stats_cuda(table: K3Table) -> GradStats:
    """Kernel K3a over the gradients the table points at. With a tp-sharded
    state the sharded tensors' squares are summed over the tp group."""
    dev = table.device
    sums = torch.empty(table.n, dtype=torch.float32, device=dev)
    totals = torch.empty(4, dtype=torch.float32, device=dev)
    nonfinite = torch.empty(1, dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        check(lib.fpcnn_optim_grad_stats(
            table.words.data_ptr(), table.mult.data_ptr(), table.grads.data_ptr(),
            table.n, table.n_chunks, CHUNK, table.partial.data_ptr(),
            table.partial_bad.data_ptr(), table.done.data_ptr(), sums.data_ptr(),
            totals.data_ptr(), nonfinite.data_ptr(), table.stream()), "optim_grad_stats")
    count_launch("optim_stats")
    own = totals[1::2]  # [logged, clip]: the sharded tensors' part
    if table.any_sharded:
        own = mesh.global_sum(own, over="tp")
    norms = torch.sqrt(totals[0::2] + own)
    return GradStats(finite=nonfinite[0] == 0, norm=norms[0], clip_norm=norms[1],
                     nonfinite=nonfinite[0], sums=sums)


@dataclasses.dataclass
class FusedUpdate:
    """Kernel K3b's launch for one step, made by `Optimizer.update` on CUDA
    and run by `apply_updates`."""
    table: K3Table
    scalars: StepScalars
    clip_norm: torch.Tensor

    def launch(self) -> None:
        t = self.table
        norm = self.clip_norm.reshape(-1)
        if norm.dtype != torch.float32 or norm.device != t.device or norm.numel() != 1:
            raise ValueError("K3: the clip norm must be one float32 value on "
                             f"{t.device}, got {norm.dtype} {tuple(norm.shape)} on {norm.device}")
        lib = load_library()
        with torch.cuda.device(t.device):
            check(lib.fpcnn_optim_update(
                t.words.data_ptr(), t.mult.data_ptr(), t.grads.data_ptr(), norm.data_ptr(),
                t.n, t.n_chunks, CHUNK, ctypes.addressof(self.scalars), t.stream()),
                "optim_update")
        count_launch("optim_update")


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


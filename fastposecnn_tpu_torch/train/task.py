"""Train and eval steps for the pose regression task (counterpart of the JAX
package's `train/task.py`).

`make_train_step` builds one step: the network in training mode (channel
dropout, BatchNorm on batch statistics), the pipeline's stages as the
preset gates them (MASK_TRAINING stops after class compression; under
HEAD_TRAINING the CC kernel K1 and the vote-count kernel K2 run on a CUDA
device), the weighted multi-task loss, the backward pass and the
optimizer. As in the JAX step:
  - gradients go through `nan_to_num`; `grad/global_norm` is their norm
    before freezing (an update is applied only when every gradient is
    finite, where `nan_to_num` changes nothing);
  - a step whose gradients are not all finite keeps the old parameters and
    optimizer state and bumps `skipped_updates`, but the BatchNorm running
    statistics of its forward pass are kept (the JAX step threads the
    mutated `batch_stats` unconditionally);
  - the random draws (dropout keep masks, vote draws) can be injected, as
    the replay of another run's draws; otherwise they come from generators
    seeded by (seed, step), the counterpart of `fold_in(rng, step)`.

Inside a process group (`parallel.mesh`) a step is the global batch's:
each rank passes its rows of the batch (and, when it injects them, the
global batch's dropout masks and vote draws, of which it takes its own;
fresh ones are drawn for the global batch and sliced), its losses are its
shares of the global ones, the gradients are summed over the dp ranks in
one all-reduce after the backward pass, and the logs are the global
batch's. Every rank then sees the same gradients, skips the same steps and
keeps bit-equal parameters. With a tp-sharded state (`mesh.shard_state_tp`)
the ranks of one tp group pass the same rows and each holds its slice of
the sharded weights and of their gradients and moments: the gradients'
global norm sums a sharded tensor's squares over the tp group, and the
gradients' finiteness and the CC kernel's error flag are reduced over the
world, so every rank skips the same steps.

The step reads two values on the host at its end: whether the gradients
were finite (to skip or apply the update) and, under HEAD_TRAINING on a
CUDA device, the CC kernel's error flag; the adaptive vote reads one flag
a round. Each goes through the tracer's `host_read` (`utils.timer`), and
the tracer's spans mark the step (`step`, `feed`, `network`, `losses`,
`backward`, `optimizer`). The step takes the network as
built, in its compute dtype (`device.compute_dtype`: a bfloat16 network on
CUDA under the default `COMPUTE_DTYPE`, as the JAX trainer builds it on a
TPU); the network returns float32 logits, so the losses, the pipeline's
stages and the optimizer (float32 parameters and moments) are float32
either way. On CUDA the step runs in `device.full_float32()`, and the
optimizer is kernel K3 (`train/optim.py`): two launches a step whatever the
number of parameters, updating the parameters and the optimizer's moments
and slow weights in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fastposecnn_tpu_torch import losses as L
from fastposecnn_tpu_torch import metrics as M
from fastposecnn_tpu_torch.data.loader import upcast_batch as _upcast_numpy
from fastposecnn_tpu_torch.device import full_float32
from fastposecnn_tpu_torch.ops.connected_components import raise_on_error_flag
from fastposecnn_tpu_torch.ops.matching import gather_matched, match_instances
from fastposecnn_tpu_torch.ops.voting import VoteDraws
from fastposecnn_tpu_torch.parallel import mesh
from fastposecnn_tpu_torch.pipeline import PipelineConfig, run_pipeline
from fastposecnn_tpu_torch.train import optim as O
from fastposecnn_tpu_torch.utils import timer

MATCH_KEYS = ("quaternion", "scales", "z", "xy", "T", "R", "RT")


@dataclasses.dataclass
class TrainState:
    """The network (its parameters and BatchNorm running statistics), the
    optimizer state, the step count and the number of skipped updates."""
    net: torch.nn.Module
    opt_state: O.OptState
    step: int = 0
    skipped_updates: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.named_parameters())


def create_train_state(net: torch.nn.Module, optimizer: O.Optimizer) -> TrainState:
    return TrainState(net=net, opt_state=optimizer.init(dict(net.named_parameters())))


def make_optimizer(hp, net: torch.nn.Module) -> O.Optimizer:
    """The optimizer chain over `net`'s parameters (`train.optim`)."""
    return O.Optimizer(hp, [n for n, _ in net.named_parameters()])


def upcast_batch(batch: Dict, device) -> Dict:
    """A numpy batch (uint8 or float NHWC image, uint8 masks) -> tensors on
    `device`; a batch of tensors is taken as already upcast."""
    if isinstance(batch["image"], torch.Tensor):
        return batch
    return _upcast_numpy(batch, device)


def compute_losses(out: Dict[str, Any], batch: Dict[str, Any], hp,
                   perform_matching: bool
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Optional[Dict]]:
    """Weighted multi-task loss. Returns (total, logs, matched payload).
    Inside a process group, `total` is this rank's share of the global loss
    and the logs are the global batch's (the shares summed over the
    ranks)."""
    logs: Dict[str, torch.Tensor] = {}
    sw = batch.get("sample_valid")
    mask_logits = out["logits"]["mask"]
    ce = L.cross_entropy(mask_logits, batch["mask"], sample_weight=sw)
    focal = L.focal_loss(mask_logits, batch["mask"], sample_weight=sw)
    logs["mask/loss_ce"] = ce
    logs["mask/loss_cce"] = ce  # CCE == CE; logged separately, as the reference
    logs["mask/loss_focal"] = focal
    mask_total = hp.MASK_WEIGHT * (ce + ce + focal)
    logs["mask/task_total_loss"] = mask_total
    total = torch.zeros((), dtype=torch.float32, device=mask_logits.device) + mask_total

    dense_weights = {"quaternion": hp.DENSE_QUAT_WEIGHT, "xy": hp.DENSE_XY_WEIGHT,
                     "z": hp.DENSE_Z_WEIGHT, "scales": hp.DENSE_SCALES_WEIGHT}
    if any(dense_weights.values()) and "agg" in batch:
        dense_total, dense_logs = L.dense_supervision(
            out["logits"], batch["mask"], batch["agg"], dense_weights,
            sample_weight=sw, sym_quat_mode=hp.DENSE_SYM_QUAT_MODE)
        logs.update(dense_logs)
        total = total + dense_total

    matched = None
    if perform_matching and out["aggregated"] is not None:
        agg = out["aggregated"]
        matched = gather_matched(agg, batch["agg"], match_instances(agg, batch["agg"]),
                                 keys=MATCH_KEYS)
        q, q_has = L.quaternion_loss(matched)
        xy, xy_has = L.xy_loss(matched, hp.XYLOSS_TYPE)
        z, z_has = L.z_loss(matched, hp.ZLOSS_TYPE)
        s, s_has = L.scales_loss(matched, hp.SCALESLOSS_TYPE)
        logs["quaternion/loss_quat"] = q
        logs["xy/loss_xy"] = xy
        logs["z/loss_z"] = z
        logs["scales/loss_scales"] = s
        total = (total + hp.QUAT_WEIGHT * q * q_has + hp.XY_WEIGHT * xy * xy_has
                 + hp.Z_WEIGHT * z * z_has + hp.SCALES_WEIGHT * s * s_has)
        logs["pose/num_matched"] = matched["valid"].float().sum()

    logs["pose/total_loss"] = total
    logs = dict(zip(logs, mesh.sum_over_ranks(logs.values())))
    return total, logs, matched


def _precision(device: torch.device):
    return full_float32() if device.type == "cuda" else contextlib.nullcontext()


def step_generators(device: torch.device, seed: int, step: int):
    """(device generator, CPU generator) for a step's draws, seeded by
    (seed, step)."""
    s = (int(seed) * 1_000_003 + int(step)) % (2 ** 63)
    return (torch.Generator(device).manual_seed(s),
            torch.Generator("cpu").manual_seed(s + 1))


def make_train_step(net: torch.nn.Module, optimizer: O.Optimizer, hp,
                    pcfg: PipelineConfig, inv_intrinsics, device):
    """The train step `step(state, batch, seed=0, dropout_keep=None,
    draws=None) -> (state, logs)`. `dropout_keep` (per decoder) and
    `draws` (`ops.voting.VoteDraws`) replay given draws; absent ones come
    from `step_generators(device, seed, state.step)`. The state is updated
    in place (the network's parameters and buffers) and returned."""
    device = torch.device(device)
    inv_k = torch.as_tensor(np.asarray(inv_intrinsics, np.float32), device=device)
    perform_matching = hp.PERFORM_MATCHING and pcfg.perform_aggregation
    if (hp.PERFORM_HOUGH_VOTING and not hp.FREEZE_TRANSLATION_TRAINING
            and hp.DENSE_XY_WEIGHT == 0.0):
        warnings.warn(
            "DENSE_XY_WEIGHT=0 with hough voting on: voting is gradient-opaque, "
            "so the xy vote field receives NO gradient (the matched xy loss is "
            "logged only). Set --DENSE_XY_WEIGHT 1.0 (the HEAD_TRAINING preset "
            "default) to train translation-xy.", stacklevel=2)

    def train_step(state: TrainState, batch, seed: int = 0,
                   dropout_keep: Optional[Dict[str, torch.Tensor]] = None,
                   draws: Optional[VoteDraws] = None):
        with timer.span("step"):
            with timer.span("feed"):
                batch = upcast_batch(batch, device)
            gen, cpu_gen = step_generators(device, seed, state.step)
            net = state.net.train()
            names, params = zip(*net.named_parameters())
            with _precision(device):
                if mesh.active():  # the global batch's masks, this rank's rows
                    keep = dropout_keep or net.draw_dropout_keep(
                        batch["image"].shape[0] * mesh.dp_size(), device, gen)
                    dropout_keep = {k: mesh.rank_rows(v).to(device) for k, v in keep.items()}
                net.zero_grad(set_to_none=True)
                with timer.span("network"):
                    logits = net(batch["image"], dropout_keep=dropout_keep, generator=gen)
                out = run_pipeline(logits, pcfg, inv_k, draws=draws, generator=gen,
                                   cpu_generator=cpu_gen)
                with timer.span("losses"):
                    total, logs, _ = compute_losses(out, batch, hp, perform_matching)
                with timer.span("backward"):
                    total.backward()
                agg = out["aggregated"]
                cc_error = agg["cc_error"] if agg is not None else None
                with timer.span("optimizer"):
                    grads = [p.grad for p in params]
                    finite = None
                    if mesh.active():
                        grads = [torch.zeros_like(p) if g is None else g
                                 for p, g in zip(params, grads)]
                        grads, finite, cc_error = _sum_grads_over_ranks(params, grads, cc_error)
                    grads, by_name = dict(zip(names, grads)), dict(zip(names, params))
                    stats = optimizer.grad_stats(grads, state.opt_state, by_name)  # K3a on CUDA
                    if finite is None:
                        finite = stats.finite
                    logs["grad/global_norm"] = stats.norm
                    logs["grad/finite"] = finite.float()
                    if agg is not None and "vote_rounds" in agg:
                        logs["pose/vote_rounds"] = torch.tensor(float(agg["vote_rounds"]))
                    opt_state, skipped = state.opt_state, state.skipped_updates
                    if timer.host_read("finite", finite.item):  # one host read a step
                        # finite: nan_to_num would change nothing
                        updates, opt_state = optimizer.update(
                            grads, state.opt_state, by_name, clip_norm=stats.clip_norm)
                        O.apply_updates(by_name, updates)  # K3b on CUDA, in place
                    else:
                        skipped += 1
            raise_on_error_flag(cc_error)
        logs = {k: v.detach() for k, v in logs.items()}
        return TrainState(net, opt_state, state.step + 1, skipped), logs

    return train_step


def _sum_grads_over_ranks(params, grads, cc_error):
    """The gradients summed over the dp ranks in one all-reduce (a
    parameter with a `.grad` gets the sum there too), and the CC kernel's
    error flag summed over the world (a flag set on any rank fails every
    rank). Data-parallel, the flag rides in the gradients' all-reduce and
    the finiteness is left to the caller (None); with a tp-sharded state
    the ranks' gradients differ, so whether every rank's are finite comes
    back too, from one all-reduce of both flags over the world."""
    flag = [] if cc_error is None else [cc_error]
    tensor_parallel = mesh.tp_size() > 1
    summed = mesh.sum_over_ranks(list(grads) + ([] if tensor_parallel else flag))
    grads = summed[:len(grads)]
    for p, g in zip(params, grads):
        if p.grad is not None:
            p.grad.copy_(g)
    if not tensor_parallel:
        return grads, None, (summed[-1] if flag else None)
    bad = torch.stack([~torch.isfinite(g).all() for g in grads]).any().float()
    flags = mesh.sum_over_ranks([bad] + flag, over="world")
    return grads, flags[0] == 0, (flags[1] if flag else None)


def make_eval_step(net: torch.nn.Module, hp, pcfg: PipelineConfig, inv_intrinsics,
                   device):
    """The eval step `step(state, batch, metric_bank, seed=0, draws=None)
    -> (logs, metric_bank, pipeline output)`: the network in eval mode, the
    same losses, the mask scores and the pose metric bank (the global
    batch's inside a process group; the output is this rank's)."""
    device = torch.device(device)
    inv_k = torch.as_tensor(np.asarray(inv_intrinsics, np.float32), device=device)
    perform_matching = hp.PERFORM_MATCHING and pcfg.perform_aggregation

    @torch.no_grad()
    def eval_step(state: TrainState, batch, metric_bank, seed: int = 0,
                  draws: Optional[VoteDraws] = None):
        batch = upcast_batch(batch, device)
        gen, cpu_gen = step_generators(device, seed, state.step)
        with _precision(device):
            logits = state.net.eval()(batch["image"])
            out = run_pipeline(logits, pcfg, inv_k, draws=draws, generator=gen,
                               cpu_generator=cpu_gen)
            _, logs, matched = compute_losses(out, batch, hp, perform_matching)
            scores = M.mask_scores(out["categorical"]["mask"], batch["mask"],
                                   hp.num_classes, sample_valid=batch.get("sample_valid"))
            logs.update({f"mask/{k}": v for k, v in scores.items()})
            if matched is not None:
                metric_bank = M.update_pose_metric_bank(metric_bank, matched)
        if out["aggregated"] is not None:
            cc_error = out["aggregated"]["cc_error"]
            if mesh.active() and cc_error is not None:  # set on any rank fails all
                cc_error = mesh.global_sum(cc_error, over="world")
            raise_on_error_flag(cc_error)
        return logs, metric_bank, out

    return eval_step

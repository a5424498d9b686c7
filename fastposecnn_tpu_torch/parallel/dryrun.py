"""A dry run of parallel training (counterpart of the JAX package's
`dryrun_multichip`, `__graft_entry__.py:52-191`): one full HEAD_TRAINING
step at 32x32 over `n` gloo processes on the CPU, the global batch of `n`
synthetic scenes split over the data ranks, the state replicated from
rank 0 and `shard_state_tp`'d.

    python -m fastposecnn_tpu_torch.parallel.dryrun [N]

As in JAX, tp = 2 when N is even and at least 4 (a genuinely 2-D mesh),
else 1; with tp = 2 at least one parameter must be tp-sharded. Every rank
must end with the same finite loss, and the whole state (gathered over
each tp group) bit-equal on every rank, at step 1.
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from fastposecnn_tpu_torch.parallel import mesh
from fastposecnn_tpu_torch.parallel.tp import sharded_names

H = W = 32


def _digest(net: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for t in net.state_dict().values():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_step(n: int, layout: mesh.Mesh):
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig, make_batch
    from fastposecnn_tpu_torch.models import network_from_hparams
    from fastposecnn_tpu_torch.models.weights import init_random_
    from fastposecnn_tpu_torch.train import task as T

    hp = C.head_training(IMAGE_HEIGHT=H, IMAGE_WIDTH=W, SELECTED_CLASSES=("bg", "bottle", "bowl"),
                         MAX_INSTANCES=4, MAX_VOTE_POINTS=128, HV_NUM_OF_HYPOTHESES=32,
                         BATCH_SIZE=n)
    # Each rank starts from other weights: replicate must give rank 0's.
    net = init_random_(network_from_hparams(hp), mesh.rank())
    opt = T.make_optimizer(hp, net)
    state = mesh.shard_state_tp(T.create_train_state(net, opt), layout)
    tp_sharded = len(sharded_names(state.net))
    if layout.tp > 1 and not tp_sharded:  # the tp sharding is real, not a no-op
        raise AssertionError("no parameter ended up tp-sharded")
    intr = np.eye(3)
    intr[0, 0] = intr[1, 1] = 60.0
    intr[0, 2], intr[1, 2] = W / 2, H / 2
    step = T.make_train_step(state.net, opt, hp, C.pipeline_config_from(hp),
                             np.linalg.inv(intr), "cpu")
    batch = make_batch(np.random.default_rng(0), SceneConfig(
        height=H, width=W, num_classes=hp.num_classes, max_instances=4,
        max_scene_instances=2, box_half_extent=(4, 9)), n)
    state, logs = step(state, mesh.shard_batch(batch), seed=1)
    whole = mesh.gather_state_tp(state)
    return float(logs["pose/total_loss"]), state.step, _digest(whole.net), tp_sharded


def dryrun_multichip(n_devices: int) -> None:
    """One HEAD_TRAINING step over `n_devices` gloo ranks laid out as the
    JAX dry run's mesh; raises unless every rank ends at step 1 with the
    same finite loss and bit-equal (gathered) parameters."""
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    layout = mesh.make_mesh(n_devices, tp=tp)
    out = mesh.launch(_rank_step, n_devices, (n_devices, layout), backend="gloo",
                      threads=1, deadline_s=600.0, layout=layout)
    losses, steps, digests, tp_sharded = zip(*out)
    if not np.isfinite(losses[0]) or len(set(losses)) != 1 or set(steps) != {1}:
        raise AssertionError(f"ranks disagree or did not step: {out}")
    if len(set(digests)) != 1:
        raise AssertionError("the ranks' parameters differ after the step")
    tp_note = f", {tp_sharded[0]} tp-sharded param tensors" if tp > 1 else ""
    print(f"dryrun_multichip({n_devices}): ok, loss={losses[0]:.4f}, "
          f"mesh={layout.shape}{tp_note}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)

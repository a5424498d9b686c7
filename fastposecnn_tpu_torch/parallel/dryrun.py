"""A dry run of data-parallel training (counterpart of the JAX package's
`dryrun_multichip`, `__graft_entry__.py:52-191`): one full HEAD_TRAINING
step at 32x32 over `n` gloo processes on the CPU, the global batch of `n`
synthetic scenes split over the ranks, the state replicated from rank 0.

    python -m fastposecnn_tpu_torch.parallel.dryrun [N]

Only `tp = 1`: tensor parallelism is not ported. Every rank must end with
the same finite loss and bit-equal parameters at step 1.
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from fastposecnn_tpu_torch.parallel import mesh

H = W = 32


def _digest(net: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for t in net.state_dict().values():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_step(n: int):
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
    state = mesh.replicate(T.create_train_state(net, opt))
    intr = np.eye(3)
    intr[0, 0] = intr[1, 1] = 60.0
    intr[0, 2], intr[1, 2] = W / 2, H / 2
    step = T.make_train_step(net, opt, hp, C.pipeline_config_from(hp), np.linalg.inv(intr),
                             "cpu")
    batch = make_batch(np.random.default_rng(0), SceneConfig(
        height=H, width=W, num_classes=hp.num_classes, max_instances=4,
        max_scene_instances=2, box_half_extent=(4, 9)), n)
    state, logs = step(state, mesh.shard_batch(batch), seed=1)
    return float(logs["pose/total_loss"]), state.step, _digest(state.net)


def dryrun_multichip(n_devices: int) -> None:
    """One data-parallel HEAD_TRAINING step over `n_devices` gloo ranks;
    raises unless every rank ends at step 1 with the same finite loss and
    bit-equal parameters."""
    mesh_ = mesh.make_mesh(n_devices)
    out = mesh.launch(_rank_step, n_devices, (n_devices,), backend="gloo", threads=1,
                      deadline_s=600.0)
    losses, steps, digests = zip(*out)
    if not np.isfinite(losses[0]) or len(set(losses)) != 1 or set(steps) != {1}:
        raise AssertionError(f"ranks disagree or did not step: {out}")
    if len(set(digests)) != 1:
        raise AssertionError("the ranks' parameters differ after the step")
    print(f"dryrun_multichip({n_devices}): ok, loss={losses[0]:.4f}, mesh={mesh_.shape}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)

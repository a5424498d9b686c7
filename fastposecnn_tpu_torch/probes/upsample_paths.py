"""Probe of the bilinear upsample's formulation in the network, for a float32
map, on the card: `F.interpolate` (align_corners=True) with its own
backward ("interpolate"), the JAX package's two products with its
interpolation matrices forward and backward ("matrix"), and the network's
own `models/fpn.py::upsample_bilinear` ("network": `F.interpolate` forward,
the products' backward). A bf16 map takes the products in all three.

    python -m fastposecnn_tpu_torch.probes.upsample_paths

Measured at 480x640, 7 classes, resnet18, seeded weights, the formulations
interleaved within one process: the served frame (`InferenceServer`, batch
1, 30 rounds) and its network alone in float32 and in bfloat16, and the
float32 HEAD_TRAINING step (batch 3, 10 rounds). Whether each
formulation's backward is reproducible: two HEAD_TRAINING steps from copies
of one state, with the same batch, dropout masks and draws, compared
gradient by gradient. And how far the logits of the formulations lie
apart. One JSON line each, then the card's name and power limit.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.constants import CAMERA_CLASSES, scaled_intrinsics
from fastposecnn_tpu_torch.data.synthetic import SceneConfig, make_batch
from fastposecnn_tpu_torch.device import full_float32
from fastposecnn_tpu_torch.models import PoseRegressorNet, fpn
from fastposecnn_tpu_torch.models.weights import init_random_
from fastposecnn_tpu_torch.serve import InferenceServer
from fastposecnn_tpu_torch.train import task as T
from fastposecnn_tpu_torch.utils.export import make_draws

H, W, CLASSES = 480, 640, 7
NETWORK_UPSAMPLE = fpn.upsample_bilinear


def matrix(x: torch.Tensor, scale: int) -> torch.Tensor:
    """The JAX package's two products, rows first, in the map's dtype."""
    h, w = x.shape[-2:]
    wy = fpn._interp_matrix_on(h, h * scale, x.device, x.dtype)
    wx = fpn._interp_matrix_on(w, w * scale, x.device, x.dtype)
    return torch.einsum("pw,bcow->bcop", wx, torch.einsum("oh,bchw->bcow", wy, x))


def interpolate_f32(x: torch.Tensor, scale: int) -> torch.Tensor:
    """`F.interpolate` for a float32 map, the matrices for a bf16 one."""
    if x.dtype != torch.bfloat16:
        return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=True)
    return matrix(x, scale)


PATHS: Dict[str, Callable] = {"interpolate": interpolate_f32, "matrix": matrix,
                              "network": NETWORK_UPSAMPLE}


def using(path: str, fn: Callable) -> Callable:
    """`fn` run with the network's bilinear upsample of formulation `path`."""
    def run():
        fpn.upsample_bilinear = PATHS[path]
        try:
            return fn()
        finally:
            fpn.upsample_bilinear = NETWORK_UPSAMPLE
    return run


def paired_ms(fns: Dict[str, Callable], pairs: int) -> Dict[str, List[float]]:
    """CUDA-event ms of each callable in `pairs` interleaved rounds, the order
    reversed every other round, after one warm-up call of each."""
    names = list(fns)
    for n in names:
        fns[n]()
    torch.cuda.synchronize()
    times: Dict[str, List[float]] = {n: [] for n in names}
    for i in range(pairs):
        for n in (names if i % 2 == 0 else names[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[n]()
            end.record()
            end.synchronize()
            times[n].append(start.elapsed_time(end))
    return times


def summary(times: List[float]) -> dict:
    return dict(median_ms=statistics.median(times),
                quartiles_ms=[float(q) for q in np.percentile(times, [25, 75])], n=len(times))


def train_run(dev, seed: int = 12):
    hp = C.head_training(IMAGE_HEIGHT=H, IMAGE_WIDTH=W, SELECTED_CLASSES=CAMERA_CLASSES[:CLASSES],
                         BATCH_SIZE=3, COMPUTE_DTYPE="float32")
    net = init_random_(PoseRegressorNet(hp.num_classes), seed).to(dev)
    opt = T.make_optimizer(hp, net)
    scenes = SceneConfig(height=H, width=W, num_classes=CLASSES,
                         max_instances=hp.MAX_INSTANCES, max_scene_instances=6)
    batch = T.upcast_batch(make_batch(np.random.default_rng(seed), scenes, 3), dev)
    inv_k = np.linalg.inv(scaled_intrinsics("CAMERA", H, W))
    step = T.make_train_step(net, opt, hp, C.pipeline_config_from(hp), inv_k, dev)
    return dict(state=T.create_train_state(net, opt), step=step, batch=batch)


def reproducible(dev, path: str) -> dict:
    """Two steps from copies of one state: how many gradients differ, and
    the largest relative L2 difference of one."""
    run = train_run(dev)
    grads = []
    for _ in range(2):
        state = T.TrainState(copy.deepcopy(run["state"].net), copy.deepcopy(run["state"].opt_state))
        using(path, lambda: run["step"](state, run["batch"], seed=3))()
        grads.append({n: p.grad.clone() for n, p in state.net.named_parameters()
                      if p.grad is not None})
    a, b = grads
    diff = [n for n in a if not torch.equal(a[n], b[n])]
    worst = max((float((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30)) for n in diff),
                default=0.0)
    return dict(tensors=len(a), differ=len(diff), worst_relative_l2=worst)


def main() -> None:
    dev = torch.device("cuda")
    out = {}
    gen = torch.Generator(dev).manual_seed(123)
    image = torch.randn((1, 3, H, W), generator=gen, device=dev)
    for dtype in ("float32", "bfloat16"):
        server = InferenceServer(device=dev, seed=0, compute_dtype=dtype)
        draws = make_draws(server.config, 1, CLASSES, dev)
        frame = paired_ms({p: using(p, lambda: server(image, draws)) for p in PATHS}, 30)

        def network():
            with torch.inference_mode(), full_float32():
                return server.net(image)

        net_ms = paired_ms({p: using(p, network) for p in PATHS}, 30)
        logits = {p: using(p, network)() for p in PATHS}
        apart = {k: float((logits["matrix"][k] - logits["interpolate"][k]).norm()
                          / logits["interpolate"][k].norm()) for k in logits["matrix"]}
        out[dtype] = dict(frame={p: summary(t) for p, t in frame.items()},
                          network={p: summary(t) for p, t in net_ms.items()},
                          logits_matrix_vs_interpolate=apart,
                          logits_network_equal_interpolate=all(
                              torch.equal(logits["network"][k], logits["interpolate"][k])
                              for k in logits["network"]))
        print(json.dumps({"probe": "upsample_paths", "served": dtype, **out[dtype]}), flush=True)
        del server
    runs = {p: train_run(dev) for p in PATHS}

    def step(p):
        r = runs[p]
        r["state"], _ = r["step"](r["state"], r["batch"], seed=1)

    steps = paired_ms({p: using(p, lambda p=p: step(p)) for p in PATHS}, 10)
    print(json.dumps({"probe": "upsample_paths", "train_step": "head_training float32 batch 3",
                      **{p: summary(t) for p, t in steps.items()}}), flush=True)
    print(json.dumps({"probe": "upsample_paths", "backward_reproducible": {
        p: reproducible(dev, p) for p in PATHS}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

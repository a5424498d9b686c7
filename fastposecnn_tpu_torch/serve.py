"""`InferenceServer`: the INFERENCE preset end to end on one device (the
counterpart of the JAX package's `__graft_entry__.entry()`).

    server = InferenceServer()            # seeded random weights, on CUDA
    mask, class_ids, xy, z, RT = server(image)   # image [B, 3, H, W] f32
    server = InferenceServer("ckpt.npz", ENCODER="resnet50", HV_IMPLEMENTATION="soft")

The hparams are the INFERENCE preset with the keyword overrides given (any
field of `config.HParams`, as the JAX inference CLI's `--ENCODER`,
`--HV_IMPLEMENTATION` and `--PRUN_*` flags), then a checkpoint's
architecture fields (`ENCODER`, the classes, ...), which win.
`weights` may be a state_dict of `PoseRegressorNet` (e.g. from
`models.weights.from_jax_params`) or the path of any checkpoint
`train.checkpoint.load_weights` reads: a JAX npz snapshot, a reference
torch checkpoint or a full checkpoint of the port's trainer.

`compute_dtype` is the served network's: "float32" (the default, as the
JAX package's `__graft_entry__.entry()` and inference CLI serve, whatever
the preset's `COMPUTE_DTYPE` says) or "bfloat16", the counterpart of the
network `bench.py` serves on its chip (`bench.py:65-68`), through the rule
of `device.compute_dtype` (bfloat16 on CUDA only). The logits are float32
either way, and so is everything after the network.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Union

import numpy as np
import torch

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch import constants
from fastposecnn_tpu_torch.device import (
    DeviceLike,
    compute_dtype as dtype_rule,
    full_float32,
    resolve_device,
)
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.weights import init_random_
from fastposecnn_tpu_torch.ops.connected_components import raise_on_error_flag
from fastposecnn_tpu_torch.ops.voting import VoteDraws
from fastposecnn_tpu_torch.pipeline import run_pipeline
from fastposecnn_tpu_torch.train.checkpoint import load_weights, merge_arch_from_any
from fastposecnn_tpu_torch.utils import timer


class InferenceServer:
    """Holds the network, the pipeline config and inv(K) on the device."""

    def __init__(self, weights: Optional[Union[str, os.PathLike, Mapping]] = None,
                 device: DeviceLike = None, seed: int = 0, compute_dtype: str = "float32",
                 **overrides):
        self.device = resolve_device(device)
        hp = dataclasses.replace(C.inference(), **overrides)
        from_file = isinstance(weights, (str, os.PathLike))
        if from_file:
            hp = merge_arch_from_any(weights, hp)
        self.hp = hp
        net = PoseRegressorNet(num_classes=hp.num_classes, encoder_name=hp.ENCODER,
                               dtype=dtype_rule(dataclasses.replace(
                                   hp, COMPUTE_DTYPE=compute_dtype), self.device))
        if weights is None:
            init_random_(net, seed)
        elif from_file:
            load_weights(net, weights, hp)
        else:
            net.load_state_dict(weights)
        self.net = net.eval().to(self.device)
        self.config = C.pipeline_config_from(self.hp)
        self.config.check_ported()
        K = constants.scaled_intrinsics(self.hp.DATASET_NAME,
                                        self.hp.IMAGE_HEIGHT, self.hp.IMAGE_WIDTH)
        self.inv_K = torch.tensor(np.linalg.inv(K), dtype=torch.float32,
                                  device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.cpu_generator = torch.Generator().manual_seed(seed + 1)

    @torch.inference_mode()
    def enqueue(self, image: torch.Tensor, draws: Optional[VoteDraws] = None):
        """Every stage of `__call__` on one image, enqueued without reading
        anything back: returns (answer, the CC kernel's unread error flag,
        None on the CPU)."""
        image = image.to(self.device, torch.float32)
        with full_float32():
            with timer.span("network"):
                logits = self.net(image)
            out = run_pipeline(logits, self.config, self.inv_K, draws=draws,
                               generator=self.generator,
                               cpu_generator=self.cpu_generator)
        agg = out["aggregated"]
        answer = (out["categorical"]["mask"], agg["class_ids"], agg["xy"],
                  agg["z"], agg["RT"])
        return answer, agg["cc_error"]

    def __call__(self, image: torch.Tensor, draws: Optional[VoteDraws] = None):
        """image [B, 3, H, W] float32 -> (mask [B, H, W] int32,
        class_ids [B, K] int32, xy [B, K, 2], z [B, K], RT [B, K, 4, 4]),
        computed in full float32 after a network in the server's compute
        dtype. The vote's random draws are `draws` (a
        `VoteDraws`, as an exported program fixes them) or come from the
        server's generators. The CC kernel's error flag is read once, after
        every stage is enqueued, and raises if set. The tracer's span
        `frame` covers the call."""
        with timer.span("frame"):
            answer, cc_error = self.enqueue(image, draws)
            raise_on_error_flag(cc_error)
        return answer

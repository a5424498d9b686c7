"""`InferenceServer`: the INFERENCE preset end to end on one device (the
counterpart of the JAX package's `__graft_entry__.entry()`).

    server = InferenceServer()            # seeded random weights, on CUDA
    mask, class_ids, xy, z, RT = server(image)   # image [B, 3, H, W] f32

`weights` may be a state_dict of `PoseRegressorNet` (e.g. from
`models.weights.from_jax_params`) or the path of a JAX npz checkpoint.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Union

import numpy as np
import torch

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch import constants
from fastposecnn_tpu_torch.device import DeviceLike, full_float32, resolve_device
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.weights import (
    from_jax_params,
    init_random_,
    load_npz_checkpoint,
)
from fastposecnn_tpu_torch.ops.connected_components import raise_on_error_flag
from fastposecnn_tpu_torch.pipeline import run_pipeline


def _state_dict(weights) -> Mapping[str, torch.Tensor]:
    if isinstance(weights, (str, os.PathLike)):
        flat, _ = load_npz_checkpoint(weights)
        return from_jax_params(flat)
    return weights


class InferenceServer:
    """Holds the network, the pipeline config and inv(K) on the device."""

    def __init__(self, weights: Optional[Union[str, os.PathLike, Mapping]] = None,
                 device: DeviceLike = None, seed: int = 0):
        self.device = resolve_device(device)
        self.hp = C.inference()
        net = PoseRegressorNet(num_classes=self.hp.num_classes)
        if weights is None:
            init_random_(net, seed)
        else:
            net.load_state_dict(_state_dict(weights))
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
    def enqueue(self, image: torch.Tensor):
        """Every stage of `__call__` on one image, enqueued without reading
        anything back: returns (answer, the CC kernel's unread error flag,
        None on the CPU)."""
        image = image.to(self.device, torch.float32)
        with full_float32():
            logits = self.net(image)
            out = run_pipeline(logits, self.config, self.inv_K,
                               generator=self.generator,
                               cpu_generator=self.cpu_generator)
        agg = out["aggregated"]
        answer = (out["categorical"]["mask"], agg["class_ids"], agg["xy"],
                  agg["z"], agg["RT"])
        return answer, agg["cc_error"]

    def __call__(self, image: torch.Tensor):
        """image [B, 3, H, W] float32 -> (mask [B, H, W] int32,
        class_ids [B, K] int32, xy [B, K, 2], z [B, K], RT [B, K, 4, 4]),
        computed in full float32. The CC kernel's error flag is read once,
        after every stage is enqueued, and raises if set."""
        answer, cc_error = self.enqueue(image)
        raise_on_error_flag(cc_error)
        return answer

"""Device resolution for the port's entry points.

An entry point called without a device runs on CUDA; if CUDA is absent it
raises instead of quietly running on the CPU. The CPU is used only when the
caller asks for it (`device="cpu"`), as the CPU tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: fastposecnn_tpu_torch entry points run on "
            "the GPU by default; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

"""Device resolution for the port's entry points.

An entry point called without a device runs on CUDA; if CUDA is absent it
raises instead of quietly running on the CPU. The CPU is used only when the
caller asks for it (`device="cpu"`), as the CPU tests do.

`full_float32()` is the precision the entry points compute in: float32
throughout, as the JAX package does, with TF32 off for cuDNN convolutions
(which PyTorch runs in TF32 by default) and for CUDA matrix products, and
cuDNN's algorithms chosen by timing.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: fastposecnn_tpu_torch entry points run on "
            "the GPU by default; pass device='cpu' (--device cpu on a command "
            "line) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def body_deterministic(caller_cudnn_tf32: bool, caller_deterministic: bool) -> bool:
    """The `cudnn.deterministic` flag `full_float32()` sets, given the
    caller's: True after a caller whose cuDNN TF32 is on (its algorithm
    cache entries differ from the body's by the TF32 flag), else the
    opposite of the caller's own flag."""
    return True if caller_cudnn_tf32 else not caller_deterministic


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Run the body in full float32: TF32 off for cuDNN convolutions and for
    CUDA matrix products.

    With TF32 off, cuDNN's heuristics pick an FFT algorithm for the FPN
    decoders' 3x3 convolutions (256 to 128 channels at 120x160) at batch 2
    to 8 that runs about 100 times slower than the one its own timing finds,
    so the body has cuDNN time its algorithms for each new shape
    (`cudnn.benchmark`). PyTorch caches the algorithm of a convolution under
    its shapes, its memory format and two flags, TF32 and
    `cudnn.deterministic`, but not under `cudnn.benchmark`: an algorithm
    that the heuristics gave to a float32 call outside this context would be
    reused here untimed, at the heuristics' speed (the order checks of
    chip_smoke.py's network_precision phase measure it). So the body sets `cudnn.deterministic` to a value under
    which the caller's own calls made no entry: after a caller with TF32 on,
    True; after a caller in float32, the opposite of the caller's flag
    (`body_deterministic`). A caller in float32 that asked for deterministic
    algorithms thus gets cuDNN's fastest ones in the body, which for the
    backward passes of training may be nondeterministic. What this cannot
    separate: a process in which callers with both values of the flag ran
    the same shapes in float32 under the heuristics before the body did.
    The caller's four flags are restored on exit, also on an exception."""
    backends = torch.backends
    saved = (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
             backends.cudnn.benchmark, backends.cudnn.deterministic)
    backends.cudnn.allow_tf32 = False
    backends.cuda.matmul.allow_tf32 = False
    backends.cudnn.benchmark = True
    backends.cudnn.deterministic = body_deterministic(saved[0], saved[3])
    try:
        yield
    finally:
        (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
         backends.cudnn.benchmark, backends.cudnn.deterministic) = saved

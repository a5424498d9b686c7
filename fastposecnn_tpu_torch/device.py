"""Device resolution for the port's entry points.

An entry point called without a device runs on CUDA; if CUDA is absent it
raises instead of quietly running on the CPU. The CPU is used only when the
caller asks for it (`device="cpu"`), as the CPU tests do.

`compute_dtype(hp, device)` is the network's compute dtype: bfloat16 when
`hp.COMPUTE_DTYPE` says "bfloat16" and the device is CUDA, else float32,
the JAX trainer's rule (`train/loop.py:195-196`) with the card in the
TPU's place. The trainers build their network with it; the server takes
its own `compute_dtype`.

`full_float32()` is the precision the entry points run in: the float32
parts (every network on the CPU, a float32 network on the card, the
losses, the skinny [slot, pixel] products, the post-network stages) in
float32 throughout, as the JAX package computes them, with TF32 off for
cuDNN convolutions (which PyTorch runs in TF32 by default) and for CUDA
matrix products, and cuDNN's algorithms chosen by timing (by its
heuristics, deterministic ones, inside a tensor-parallel group). A bfloat16
network's convolutions and products are not affected by the TF32 flags.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple, Union

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


def compute_dtype(hp, device: Union[str, torch.device]) -> torch.dtype:
    """torch.bfloat16 iff `hp.COMPUTE_DTYPE == "bfloat16"` and `device` is a
    CUDA device; torch.float32 otherwise (any other string included)."""
    if hp.COMPUTE_DTYPE == "bfloat16" and torch.device(device).type == "cuda":
        return torch.bfloat16
    return torch.float32


def body_deterministic(caller_cudnn_tf32: bool, caller_deterministic: bool) -> bool:
    """The `cudnn.deterministic` flag `full_float32()` sets, given the
    caller's: True after a caller whose cuDNN TF32 is on (its algorithm
    cache entries differ from the body's by the TF32 flag), else the
    opposite of the caller's own flag."""
    return True if caller_cudnn_tf32 else not caller_deterministic


def tp_flags() -> Tuple[bool, bool]:
    """(`cudnn.benchmark`, `cudnn.deterministic`) in `full_float32()` inside
    a tensor-parallel group: the heuristics' deterministic algorithms, the
    same on every rank for the same shapes."""
    return False, True


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Run the body's float32 work in full float32: TF32 off for cuDNN
    convolutions and for CUDA matrix products (a bfloat16 convolution or
    product in the body is not affected by these flags).

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
    The caller's four flags are restored on exit, also on an exception.

    In a tensor-parallel group (`parallel.mesh.tp_size() > 1`) the body
    takes cuDNN's heuristics instead, with deterministic algorithms
    (`tp_flags`): every rank of a tp group computes the replicated parts of
    the network (everything outside the sharded convolutions) on the same
    shapes and must compute them alike, and algorithms chosen by each
    rank's own timing differ from rank to rank and from run to run."""
    from fastposecnn_tpu_torch.parallel import mesh

    backends = torch.backends
    saved = (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
             backends.cudnn.benchmark, backends.cudnn.deterministic)
    backends.cudnn.allow_tf32 = False
    backends.cuda.matmul.allow_tf32 = False
    if mesh.tp_size() > 1:
        backends.cudnn.benchmark, backends.cudnn.deterministic = tp_flags()
    else:
        backends.cudnn.benchmark = True
        backends.cudnn.deterministic = body_deterministic(saved[0], saved[3])
    try:
        yield
    finally:
        (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
         backends.cudnn.benchmark, backends.cudnn.deterministic) = saved

"""Connected-component labelling (4-connectivity) and instance extraction
(counterpart of the JAX package's `ops/connected_components.py`).

Every foreground pixel is labelled with the smallest row-major linear index
of its component; background is -1.

The custom op `fastposecnn::cc_label` (`torch.library`) sends a CUDA tensor
to the hand-written kernel `kernels/cc_label.cu` and a CPU tensor to the
plain version `label_components_reference`, and returns (labels, error
flag); a `register_fake` gives their shapes and dtypes, so `torch.export`
records the op in a program (`utils/export.py`) and the loaded program
launches the kernel on the card. `label_components` and
`label_components_deferred` go through the op; `impl="reference"` forces
the plain version on either device.

The kernel sets its error flag (int32 [1]) on the device when a loop passes
its step bound. Reading it waits for the device, so an entry point that
enqueues more work takes the flag unread from `label_components_deferred`
and reads it once at its end with `raise_on_error_flag`;
`label_components` reads it at once. The plain version sets no flag (a
zero).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fastposecnn_tpu_torch.kernels import count_launch
from fastposecnn_tpu_torch.kernels.build import check, load_library
from fastposecnn_tpu_torch.utils import timer

_BIG = 2**31 - 1


def label_components_reference(fg: torch.Tensor) -> torch.Tensor:
    """Plain version: 4-neighbour min-propagation plus pointer jumping, up to
    the fixpoint, with a hard bound of H*W iterations.

    fg [B, H, W] (bool or 0/1 ints) -> [B, H, W] int32 root index / -1.
    """
    fgb = fg != 0
    b, h, w = fgb.shape
    hw = h * w
    lin = torch.arange(hw, device=fg.device).reshape(1, h, w)
    big = torch.full((), _BIG, dtype=torch.int64, device=fg.device)
    lbl = torch.where(fgb, lin, big)
    for _ in range(hw + 1):
        new = lbl.clone()
        new[..., 1:] = torch.minimum(new[..., 1:], lbl[..., :-1])
        new[..., :-1] = torch.minimum(new[..., :-1], lbl[..., 1:])
        new[..., 1:, :] = torch.minimum(new[..., 1:, :], lbl[..., :-1, :])
        new[..., :-1, :] = torch.minimum(new[..., :-1, :], lbl[..., 1:, :])
        new = torch.where(fgb, new, big).reshape(b, hw)
        is_bg = new == _BIG
        jumped = torch.gather(new, 1, torch.where(is_bg, 0, new))
        new = torch.where(is_bg, big, jumped).reshape(b, h, w)
        if torch.equal(new, lbl):
            break
        lbl = new
    else:
        raise RuntimeError(f"label_components_reference did not converge "
                           f"within {hw + 1} iterations")
    return torch.where(fgb, lbl, -1).to(torch.int32)


def new_error_flag(like: torch.Tensor) -> Optional[torch.Tensor]:
    """A cleared error flag (int32 [1]) on `like`'s device when that is a
    CUDA device, else None (the plain version sets no flag)."""
    if not like.is_cuda:
        return None
    return torch.zeros(1, dtype=torch.int32, device=like.device)


def raise_on_error_flag(err: Optional[torch.Tensor]) -> None:
    """Read the kernel's error flag (waits for the device; the tracer's
    host read `cc_flag`) and raise if it is set; None, from the CPU,
    passes."""
    if err is not None and timer.host_read("cc_flag", err.item) != 0:
        raise RuntimeError("cc_label: a device loop passed its step bound")


def label_components_cuda(fg: torch.Tensor,
                          err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K1 (`kernels/cc_label.cu`) on a CUDA tensor. Given `err` (int32
    [1] on fg's device), the kernel sets it and the wrapper returns without
    reading it; without, the wrapper makes one and raises at once."""
    if not fg.is_cuda or fg.dim() != 3:
        raise ValueError(f"cc_label needs a CUDA [B, H, W] tensor, got "
                         f"{tuple(fg.shape)} on {fg.device}")
    b, h, w = fg.shape
    if h * w >= 2**31 or b >= 2**16:
        raise ValueError(f"cc_label: a batch of {b} images of {h}x{w} pixels is "
                         f"too large")
    deferred = err is not None
    if deferred and (err.dtype != torch.int32 or err.shape != (1,)
                     or err.device != fg.device):
        raise ValueError(f"cc_label: the error flag must be int32 [1] on "
                         f"{fg.device}, got {err.dtype} {tuple(err.shape)} on "
                         f"{err.device}")
    lib = load_library()
    # The kernel reads one byte per pixel: a bool mask goes in as it is.
    fg8 = (fg if fg.dtype == torch.bool else fg != 0).contiguous().view(torch.uint8)
    out = torch.empty(fg.shape, dtype=torch.int32, device=fg.device)
    if not deferred:
        err = new_error_flag(fg)
    with torch.cuda.device(fg.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.fpcnn_cc_label(fg8.data_ptr(), out.data_ptr(),
                                 err.data_ptr(), b, h, w, stream), "cc_label")
    count_launch("cc_label")
    if not deferred:
        raise_on_error_flag(err)
    return out


@torch.library.custom_op("fastposecnn::cc_label", mutates_args=(), device_types="cpu")
def cc_label(fg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fg [B, H, W] -> (labels [B, H, W] int32 root index / -1, error flag
    int32 [1]). This body is the op's CPU implementation: the plain
    version, whose flag is always clear."""
    return label_components_reference(fg), torch.zeros(1, dtype=torch.int32)


@cc_label.register_kernel("cuda")
def _cc_label_cuda(fg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    err = new_error_flag(fg)
    return label_components_cuda(fg, err), err


@cc_label.register_fake
def _cc_label_fake(fg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (fg.new_empty(fg.shape, dtype=torch.int32),
            fg.new_empty((1,), dtype=torch.int32))


def _check_impl(fg: torch.Tensor, impl: Optional[str]) -> None:
    if impl not in (None, "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if fg.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {fg.device}")


def label_components_deferred(fg: torch.Tensor, impl: Optional[str] = None
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """fg [B, H, W] -> (labels, the kernel's error flag unread: a CUDA
    int32 [1] tensor, or None from the plain version)."""
    _check_impl(fg, impl)
    if impl == "reference":
        return label_components_reference(fg), None
    labels, err = cc_label(fg)
    return labels, (err if fg.is_cuda else None)


def label_components(fg: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
    """fg [B, H, W] -> [B, H, W] int32 root index / -1, through the op; on
    CUDA the kernel's error flag is read at once."""
    labels, err = label_components_deferred(fg, impl)
    raise_on_error_flag(err)
    return labels


def extract_instances(labels: torch.Tensor, max_instances: int):
    """Root-index label map [B, H, W] -> padded per-instance binary masks.

    Returns masks [B, K, H, W] float32, valid [B, K] bool and roots [B, K]
    int32 (int32 max on invalid slots).

    The K components with the largest area estimate are kept: areas are
    counted on a strided subsample (stride max(1, round(sqrt(HW/4800))), 8
    at 480x640) plus 0.5, so every root stays eligible; among equal scores
    the smallest root wins (a stable descending sort over the score). The
    kept slots are then ordered by root; invalid slots sink to the end.
    """
    b, h, w = labels.shape
    hw = h * w
    k = max_instances
    stride = max(1, int(round((hw / 4800.0) ** 0.5)))
    flat = labels.reshape(b, hw).long()
    lin = torch.arange(hw, device=labels.device)
    is_root = flat == lin
    sub = labels[:, ::stride, ::stride].reshape(b, -1).long()
    fg_s = sub >= 0
    areas = torch.zeros(b, hw, dtype=torch.float32, device=labels.device)
    areas.scatter_add_(1, torch.where(fg_s, sub, 0), fg_s.float())
    score = torch.where(is_root, areas + 0.5, torch.full_like(areas, -1.0))
    top = torch.sort(score, dim=1, descending=True, stable=True)
    big = torch.full((), _BIG, dtype=torch.int64, device=labels.device)
    roots = torch.where(top.values[:, :k] > 0.0, top.indices[:, :k], big)
    roots = torch.sort(roots, dim=1).values
    valid = roots != _BIG
    masks = (flat[:, None, :] == roots[:, :, None]) & valid[:, :, None]
    return masks.reshape(b, k, h, w).float(), valid, roots.to(torch.int32)

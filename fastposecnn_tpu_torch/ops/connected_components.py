"""Connected-component labelling (4-connectivity) and instance extraction
(counterpart of the JAX package's `ops/connected_components.py`).

Every foreground pixel is labelled with the smallest row-major linear index
of its component; background is -1. `label_components` sends a CUDA tensor
to the hand-written kernel `kernels/cc_label.cu` and a CPU tensor to the
plain version `label_components_reference`; `impl="reference"` forces the
plain version on either device.

The kernel sets an error flag on the device when a loop passes its step
bound. Reading it waits for the device, so a caller that enqueues more work
passes its own flag (`new_error_flag`) and reads it once at its end with
`raise_on_error_flag`; without one, the wrapper reads it at once.
"""

from __future__ import annotations

from typing import Optional

import torch

from fastposecnn_tpu_torch.kernels import count_launch
from fastposecnn_tpu_torch.kernels.build import check, load_library

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
    """Read the kernel's error flag (waits for the device) and raise if it
    is set; None, from the CPU, passes."""
    if err is not None and int(err.item()) != 0:
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


def label_components(fg: torch.Tensor, impl: Optional[str] = None,
                     err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fg [B, H, W] -> [B, H, W] int32 root index / -1. CUDA tensors go to
    the kernel (which sets `err` when given, see `label_components_cuda`),
    CPU tensors to the plain version, which sets no flag."""
    if impl == "reference":
        return label_components_reference(fg)
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}")
    if fg.is_cuda:
        return label_components_cuda(fg, err)
    if fg.device.type == "cpu":
        return label_components_reference(fg)
    raise ValueError(f"unsupported device {fg.device}")


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

"""Connected-component labelling (4-connectivity) and instance extraction
(counterpart of the JAX package's `ops/connected_components.py`).

Every foreground pixel is labelled with the smallest row-major linear index
of its component; background is -1. `label_components` sends a CUDA tensor
to the hand-written kernel `kernels/cc_label.cu` and a CPU tensor to the
plain version `label_components_reference`; `impl="reference"` forces the
plain version on either device.
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


def label_components_cuda(fg: torch.Tensor) -> torch.Tensor:
    """Kernel K1 (`kernels/cc_label.cu`) on a CUDA tensor."""
    if not fg.is_cuda or fg.dim() != 3:
        raise ValueError(f"cc_label needs a CUDA [B, H, W] tensor, got "
                         f"{tuple(fg.shape)} on {fg.device}")
    b, h, w = fg.shape
    if h * w >= 2**31:
        raise ValueError(f"cc_label: image of {h}x{w} pixels is too large")
    lib = load_library()
    # The kernel reads one byte per pixel: a bool mask goes in as it is.
    fg8 = (fg if fg.dtype == torch.bool else fg != 0).contiguous().view(torch.uint8)
    out = torch.empty(fg.shape, dtype=torch.int32, device=fg.device)
    err = torch.zeros(1, dtype=torch.int32, device=fg.device)
    with torch.cuda.device(fg.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.fpcnn_cc_label(fg8.data_ptr(), out.data_ptr(),
                                 err.data_ptr(), b, h, w, stream), "cc_label")
    count_launch("cc_label")
    if int(err.item()) != 0:
        raise RuntimeError("cc_label: a device loop passed its step bound")
    return out


def label_components(fg: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
    """fg [B, H, W] -> [B, H, W] int32 root index / -1. CUDA tensors go to
    the kernel, CPU tensors to the plain version."""
    if impl == "reference":
        return label_components_reference(fg)
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}")
    if fg.is_cuda:
        return label_components_cuda(fg)
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

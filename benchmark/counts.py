"""The yardstick's arithmetic: the card's published peaks, the operations of
the network's convolutions, and the least time of kernels K1 and K2.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
FP32 outside the tensor cores is 67 TFLOP/s counting a fused multiply-add
as two operations, so 33.5 T/s for the unfused adds and multiplies of a
kernel built with -fmad=false (K2 is).

K1 (connected components, `kernels/cc_label.cu`) is bound by bytes: each
pixel's mask byte read once and its int32 label written once. K2 (inlier
counts, `kernels/vote_count.cu`) by the larger of its FP32 operations, 11
per (slot, hypothesis, point) cell of an active slot's valid point (2
subtractions, 6 multiplications, 3 additions), and the bytes of its inputs
and output. Both copied from `chip_smoke.py` (`time_cc`, `vote_bound`).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_UNFUSED_OPS_PER_S = 67e12 / 2
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
VOTE_FLOPS_PER_CELL = 11
K1_BYTES_PER_PIXEL = 1 + 4


def k1_bound_s(pixels: int) -> float:
    return pixels * K1_BYTES_PER_PIXEL / HBM_BYTES_PER_S


def k2_bound_s(cells: float, nbytes: float) -> float:
    return max(cells * VOTE_FLOPS_PER_CELL / FP32_UNFUSED_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def k2_cells(pvalid: torch.Tensor, active: Optional[torch.Tensor], hypotheses: int
             ) -> torch.Tensor:
    """The cells K2 computes on: (valid point of an active slot) x hypothesis,
    as a device scalar (no host read)."""
    valid = pvalid != 0
    if active is not None:
        valid = valid & (active != 0)[:, None]
    return valid.sum() * hypotheses


def conv_flops(net: torch.nn.Module, image_shape, trained: Iterable[str] = ()
               ) -> Dict[str, float]:
    """Operations of every convolution of `net` for one input of
    `image_shape` (C, H, W), found by running `net` on the meta device:
    2 x Cout x Hout x Wout x Cin / groups x kh x kw each (a multiply-add is
    two). `forward` is the sum; `backward` counts, for the convolutions of
    the top-level modules in `trained`, the weight gradient (as many as the
    forward) and the input gradient (as many again) where the input needs a
    gradient: every convolution but one whose input is the image."""
    convs = []

    def hook(mod, inputs, output):
        kh, kw = mod.kernel_size
        cin = mod.in_channels // mod.groups
        flops = 2.0 * output.shape[1] * output.shape[2] * output.shape[3] * cin * kh * kw
        convs.append((mod, flops, inputs[0].shape[1] == image_shape[0]
                      and tuple(inputs[0].shape[2:]) == tuple(image_shape[1:])))

    owner = {}
    for top, child in net.named_children():
        for mod in child.modules():
            owner[mod] = top
    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        meta = net.to("meta")
        with torch.no_grad():
            meta.eval()(torch.empty((1,) + tuple(image_shape), device="meta"))
    finally:
        for h in handles:
            h.remove()
    trained = set(trained)
    forward = sum(f for _, f, _ in convs)
    backward = sum(f * (1 if on_image else 2) for m, f, on_image in convs
                   if owner.get(m) in trained)
    return {"forward": forward, "backward": backward, "convolutions": len(convs)}

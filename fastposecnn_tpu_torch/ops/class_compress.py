"""Class compression: collapse per-class dense predictions onto the argmax
class (counterpart of the JAX package's `ops/class_compress.py:40-83`).

Takes the network's NCHW logits (per-class fields flat and class-major) and
returns the categorical data in the JAX package's channel-last layout.
"""

from __future__ import annotations

from typing import Dict

import torch

from fastposecnn_tpu_torch.geometry import safe_normalize


def _select_class(field: torch.Tensor, cls_idx: torch.Tensor,
                  fg: torch.Tensor, k: int) -> torch.Tensor:
    """field [B, (C-1)k, H, W], cls_idx/fg [B, H, W] -> [B, H, W, k]: the k
    channels of each pixel's class, zero on background."""
    b, _, h, w = field.shape
    f = field.reshape(b, -1, k, h * w)
    idx = cls_idx.reshape(b, 1, 1, h * w).expand(b, 1, k, h * w)
    out = torch.gather(f, 1, idx)[:, 0]  # [B, k, HW]
    out = torch.where(fg.reshape(b, 1, h * w), out, torch.zeros_like(out))
    return out.transpose(1, 2).reshape(b, h, w, k)


def class_compress(logits: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """NCHW logits -> categorical data:
      mask       [B, H, W] int32 argmax class (background 0)
      quaternion [B, H, W, 4] L2-normalized, 0 on background
      xy         [B, H, W, 2] L2-normalized, 0 on background
      z          [B, H, W]    0 on background
      scales     [B, H, W, 3] 0 on background
    """
    cat_mask = torch.argmax(logits["mask"], dim=1).to(torch.int32)
    fg = cat_mask > 0
    cls_idx = (cat_mask.long() - 1).clamp_min(0)
    quat = _select_class(logits["quaternion"], cls_idx, fg, 4)
    xy = _select_class(logits["xy"], cls_idx, fg, 2)
    z = _select_class(logits["z"], cls_idx, fg, 1)[..., 0]
    scales = _select_class(logits["scales"], cls_idx, fg, 3)
    return {
        "mask": cat_mask,
        "quaternion": safe_normalize(quat),
        "xy": safe_normalize(xy),
        "z": z,
        "scales": scales,
    }

"""Instance aggregation: dense per-pixel predictions -> per-instance values
(counterpart of the JAX package's `ops/aggregation.py:34-103`).

Masked means are one [K, HW] x [HW, k] product per image (`torch.bmm`). The
instance's class id is the smallest nonzero class inside it (a quirk of the
reference, kept); z is the exp of the mean of log-depth.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fastposecnn_tpu_torch.geometry import safe_normalize
from fastposecnn_tpu_torch.ops.connected_components import (
    extract_instances,
    label_components,
)

_INT32_MAX = 2**31 - 1


def aggregate_instances(cat_data: Dict[str, torch.Tensor], max_instances: int,
                        impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Categorical data (from `class_compress`) -> padded instance data:
    instance_masks [B, K, H, W], valid [B, K], class_ids [B, K] int32,
    quaternion [B, K, 4], scales [B, K, 3], z [B, K], plus `xy_dense`,
    `cat_mask`, `cc_labels` and `cc_roots` passed through for voting."""
    cat_mask = cat_data["mask"]
    b, h, w = cat_mask.shape
    hw = h * w
    labels = label_components(cat_mask != 0, impl=impl)
    masks, valid, roots = extract_instances(labels, max_instances)
    flat_masks = masks.reshape(b, max_instances, hw)
    safe_area = flat_masks.sum(-1).clamp_min(1.0)

    cls = cat_mask.reshape(b, 1, hw)
    masked_cls = torch.where((flat_masks > 0) & (cls > 0), cls,
                             torch.full_like(cls, _INT32_MAX))
    class_ids = masked_cls.amin(dim=-1)
    class_ids = torch.where(valid, class_ids, 0).to(torch.int32)

    def masked_mean(field: torch.Tensor) -> torch.Tensor:
        flat = field.reshape(b, hw, field.shape[-1])
        return torch.bmm(flat_masks, flat) / safe_area[..., None]

    quat = safe_normalize(masked_mean(cat_data["quaternion"]))
    scales = masked_mean(cat_data["scales"])
    z = torch.exp(masked_mean(cat_data["z"][..., None])[..., 0])

    vf = valid.float()
    return {
        "instance_masks": masks * vf[..., None, None],
        "valid": valid,
        "class_ids": class_ids,
        "quaternion": quat * vf[..., None],
        "scales": scales * vf[..., None],
        "z": z * vf,
        "xy_dense": cat_data["xy"],
        "cat_mask": cat_mask,
        "cc_labels": labels,
        "cc_roots": roots,
    }

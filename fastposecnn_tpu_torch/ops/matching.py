"""GT <-> prediction instance matching by 2D mask IoU (counterpart of the
JAX package's `ops/matching.py`).

Fixed shapes: GT instances [B, G] and predictions [B, N] with validity
masks; each GT slot gets one (pred index, valid) pair, matching within its
own image only.
"""

from __future__ import annotations

from typing import Dict

import torch


def mask_iou_matrix(gt_masks: torch.Tensor, pred_masks: torch.Tensor) -> torch.Tensor:
    """[B, G, H, W] x [B, N, H, W] binary masks -> IoU [B, G, N].

    The intersections are one [G, HW] x [HW, N] product per image. The
    operands hold 0/1 and the product accumulates in float32, so every
    count is an integer below 2^24 and exact for images under 2^24 pixels
    (TF32 operands would hold 0/1 exactly too)."""
    b, g = gt_masks.shape[:2]
    n = pred_masks.shape[1]
    gt_flat = gt_masks.reshape(b, g, -1).float()
    pred_flat = pred_masks.reshape(b, n, -1).float()
    inter = torch.bmm(gt_flat, pred_flat.transpose(1, 2))
    union = gt_flat.sum(-1)[:, :, None] + pred_flat.sum(-1)[:, None, :] - inter
    return inter / union.clamp_min(1.0)


def match_instances(preds: Dict[str, torch.Tensor],
                    gts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Pair each GT slot with the same-class valid prediction of highest
    mask IoU (the first on ties).

    Returns pred_idx [B, G] int64, valid [B, G] bool (a same-class match
    with IoU > 0 exists) and iou [B, G]."""
    iou = mask_iou_matrix(gts["instance_masks"], preds["instance_masks"])
    same_class = gts["class_ids"][:, :, None] == preds["class_ids"][:, None, :]
    allowed = same_class & gts["valid"][:, :, None] & preds["valid"][:, None, :]
    scored = torch.where(allowed, iou, -1.0)
    pred_idx = torch.argmax(scored, dim=-1)  # the first maximal index
    best = scored.amax(dim=-1)
    return {"pred_idx": pred_idx, "valid": best > 0.0, "iou": best.clamp_min(0.0)}


def _standard_pred(key: str, like: torch.Tensor) -> torch.Tensor:
    """The reference's placeholder for a missed instance: zeros, except
    quaternion [1, 0, 0, 0], RT = identity and z = 1000."""
    std = torch.zeros_like(like)
    if key == "quaternion":
        std[..., 0] = 1.0
    elif key == "RT":
        std = std + torch.eye(4, dtype=like.dtype, device=like.device)
    elif key == "z":
        std = std + 1000.0
    return std


def gather_matched(preds: Dict[str, torch.Tensor], gts: Dict[str, torch.Tensor],
                   match: Dict[str, torch.Tensor],
                   keys: tuple = ("quaternion", "scales", "z", "xy", "T", "R", "RT"),
                   fill_missing: bool = False) -> Dict[str, torch.Tensor]:
    """The matched-pair payload for losses and metrics: `gt_<key>` and
    `pred_<key>` [B, G, ...] per key, plus `valid`, `class_ids` and
    `symmetric_ids`.

    The predictions are gathered with `torch.gather` (the JAX code uses a
    one-hot product, equal for finite values). `fill_missing=True` pairs an
    unmatched GT with the standard prediction and counts it valid."""
    matched = match["valid"] & gts["valid"]
    out = {
        "valid": gts["valid"] if fill_missing else matched,
        "class_ids": gts["class_ids"],
        "symmetric_ids": gts.get("symmetric_ids",
                                 torch.zeros_like(gts["class_ids"])),
    }
    idx = match["pred_idx"]
    for key in keys:
        if key in gts:
            out[f"gt_{key}"] = gts[key]
        if key in preds:
            field = preds[key]
            index = idx.reshape(idx.shape + (1,) * (field.ndim - 2))
            pred = torch.gather(field, 1, index.expand(idx.shape + field.shape[2:]))
            if fill_missing:
                mshape = matched.shape + (1,) * (pred.ndim - 2)
                pred = torch.where(matched.reshape(mshape), pred,
                                   _standard_pred(key, pred))
            out[f"pred_{key}"] = pred
    return out

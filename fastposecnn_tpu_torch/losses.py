"""Loss functions, mask-aware and fixed-shape (counterpart of the JAX
package's `losses.py`).

Every matched loss consumes a validity mask and returns `(value, has_data)`:
`value` is a masked mean (0 when nothing is valid) and `has_data` (float
0/1) says whether any instance contributed, which the train step uses where
the reference dropped NaN losses.

Layouts: the mask logits and the dense head fields are the network's NCHW
outputs (`[B, C, H, W]`, per-class fields flat and class-major); the dense
GT mask is `[B, H, W]`; matched payloads (`ops.matching.gather_matched`)
hold `gt_<k>` / `pred_<k>` of shape [B, G, ...] plus `valid` and
`symmetric_ids` [B, G].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from fastposecnn_tpu_torch import geometry

Tensor = torch.Tensor
LossOut = Tuple[Tensor, Tensor]  # (scalar loss, has_data flag as float 0/1)


def _masked_mean(x: Tensor, mask: Tensor) -> LossOut:
    mask = mask.to(x.dtype)
    total = mask.sum()
    value = (x * mask).sum() / total.clamp_min(1.0)
    return value, (total > 0).to(x.dtype)


def _weighted_sample_mean(per_sample: Tensor, sample_weight: Tensor) -> Tensor:
    """sum_b x_b w_b / max(sum_b w_b, 1) over the leading axis."""
    w = sample_weight.to(per_sample.dtype)
    w = w.reshape(w.shape + (1,) * (per_sample.ndim - 1))
    return (per_sample * w).sum(0) / w.sum().clamp_min(1.0)


# -----------------------------------------------------------------------------
# Pixel-wise mask losses


def cross_entropy(mask_logits: Tensor, gt_mask: Tensor,
                  sample_weight: Optional[Tensor] = None) -> Tensor:
    """Mean cross-entropy of [B, C, H, W] logits against [B, H, W] class
    ids. With `sample_weight` [B] (0 for the padded samples of a short
    batch), a weighted mean over samples of per-sample pixel means."""
    logp = F.log_softmax(mask_logits, dim=1)
    ce = -logp.gather(1, gt_mask.long()[:, None])[:, 0]  # [B, H, W]
    if sample_weight is None:
        return ce.mean()
    return _weighted_sample_mean(ce.mean(dim=(1, 2)), sample_weight)


def focal_loss(mask_logits: Tensor, gt_mask: Tensor, alpha: float = 0.5,
               gamma: float = 2.0,
               sample_weight: Optional[Tensor] = None) -> Tensor:
    """The reference's focal loss: for each class c, the sigmoid binary focal
    loss of x = log_softmax(logits)[c] (log-probabilities used as logits, a
    quirk kept) against t = (gt == c), averaged over pixels and summed over
    classes."""
    logp = F.log_softmax(mask_logits, dim=1)
    onehot = F.one_hot(gt_mask.long(), mask_logits.shape[1]).permute(
        0, 3, 1, 2).to(logp.dtype)
    logpt = -(F.softplus(-logp) * onehot + F.softplus(logp) * (1 - onehot))
    pt = torch.exp(logpt)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    per_class = alpha_t * (1 - pt) ** gamma * (-logpt)  # [B, C, H, W]
    per_sample = per_class.mean(dim=(2, 3))  # [B, C]
    if sample_weight is None:
        return per_sample.mean(0).sum()
    return _weighted_sample_mean(per_sample, sample_weight).sum()


def masked_mse(pred_dense: Tensor, gt_dense: Tensor,
               pred_cat_mask: Tensor) -> LossOut:
    """MSE of channel-last dense predictions zeroed outside the predicted
    foreground, against the dense GT."""
    fg = (pred_cat_mask != 0).to(pred_dense.dtype)
    while fg.ndim < pred_dense.ndim:
        fg = fg[..., None]
    mse = ((pred_dense * fg - gt_dense) ** 2).mean()
    return mse, (fg.sum() > 0).to(pred_dense.dtype)


# -----------------------------------------------------------------------------
# Matched losses


def _elementwise(kind: str, diff_gt: Tensor, diff_pred: Tensor) -> Tensor:
    d = diff_gt - diff_pred
    if kind == "L1":
        return d.abs()
    if kind == "L2":
        return d * d
    if kind == "SmoothL1":
        a = d.abs()
        return torch.where(a < 1.0, 0.5 * d * d, a - 0.5)
    raise NotImplementedError(f"{kind} is an invalid loss function!")


def quaternion_loss(matched: Dict[str, Tensor], eps: float = 0.1,
                    num_steps: int = 360) -> LossOut:
    """log(1 - <gt, pred>^2 + eps) - log(eps); a symmetric instance takes
    the least loss over `num_steps` y-rotations of the GT."""
    gt, pred = matched["gt_quaternion"], matched["pred_quaternion"]
    sym = matched["symmetric_ids"] != 0

    def dp_to_loss(dot):
        return torch.log(1.0 - dot ** 2 + eps) - torch.log(
            torch.full_like(dot, eps))

    plain = dp_to_loss((gt * pred).sum(-1))
    rot_q = geometry._symmetry_rotation_quats(num_steps, gt)
    rot_gt = geometry.quat_multiply_wxyz(gt[..., None, :], rot_q)  # [B,G,S,4]
    sym_loss = dp_to_loss((pred[..., None, :] * rot_gt).sum(-1)).amin(-1)
    return _masked_mean(torch.where(sym, sym_loss, plain), matched["valid"])


def xy_loss(matched: Dict[str, Tensor], kind: str = "L1") -> LossOut:
    """Per-coordinate loss on the voted 2D centre: a mean per coordinate,
    summed over x and y."""
    per_coord = _elementwise(kind, matched["gt_xy"], matched["pred_xy"])
    m0, has = _masked_mean(per_coord[..., 0], matched["valid"])
    m1, _ = _masked_mean(per_coord[..., 1], matched["valid"])
    return m0 + m1, has


def z_loss(matched: Dict[str, Tensor], kind: str = "L1") -> LossOut:
    """Depth loss in log space."""
    gt = torch.log(matched["gt_z"].clamp_min(1e-8))
    pred = torch.log(matched["pred_z"].clamp_min(1e-8))
    return _masked_mean(_elementwise(kind, gt, pred), matched["valid"])


def scales_loss(matched: Dict[str, Tensor], kind: str = "L1") -> LossOut:
    """Per-dimension scales loss, summed over the three dimensions."""
    per_dim = _elementwise(kind, matched["gt_scales"], matched["pred_scales"])
    total = torch.zeros((), dtype=per_dim.dtype, device=per_dim.device)
    has = total
    for i in range(per_dim.shape[-1]):
        m, has = _masked_mean(per_dim[..., i], matched["valid"])
        total = total + m
    return total, has


def rotation_matrix_loss(matched: Dict[str, Tensor]) -> LossOut:
    """Geodesic loss acos((tr(gt^T pred) - 1) / 2)."""
    sim = torch.einsum("...ji,...jk->...ik", matched["gt_R"], matched["pred_R"])
    tr = sim.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos = ((tr - 1.0) / 2.0).clamp(-1.0 + 1e-7, 1.0 - 1e-7)
    return _masked_mean(torch.arccos(cos), matched["valid"])


def _safe_norm(diff: Tensor) -> Tensor:
    """||diff|| with a finite gradient where diff is exactly zero (padded
    slots have gt == pred == 0)."""
    sq = (diff * diff).sum(-1)
    nonzero = sq > 0
    return torch.sqrt(torch.where(nonzero, sq, torch.ones_like(sq))) * nonzero


def translation_loss(matched: Dict[str, Tensor]) -> LossOut:
    """Mean ||gt_T - pred_T||."""
    return _masked_mean(_safe_norm(matched["gt_T"] - matched["pred_T"]),
                        matched["valid"])


def iou3d_loss(matched: Dict[str, Tensor]) -> LossOut:
    """1 - IoU3D."""
    iou = geometry.asymmetric_3d_iou(matched["gt_RT"], matched["pred_RT"],
                                     matched["gt_scales"], matched["pred_scales"])
    return _masked_mean(1.0 - iou, matched["valid"])


def offset_loss(matched: Dict[str, Tensor]) -> LossOut:
    """Distance of the RT-derived world centres (x10 then /10, the
    reference's own pair of scalings, kept)."""
    def centre(RT):
        return RT[..., :3, :3].transpose(-1, -2) @ (-RT[..., :3, 3:])

    err = _safe_norm(centre(matched["gt_RT"])[..., 0]
                     - centre(matched["pred_RT"])[..., 0]) * 10.0
    return _masked_mean(err / 10.0, matched["valid"])


MATCHED_LOSSES = {
    "quaternion": quaternion_loss,
    "xy": xy_loss,
    "z": z_loss,
    "scales": scales_loss,
    "R": rotation_matrix_loss,
    "T": translation_loss,
    "iou3d": iou3d_loss,
    "offset": offset_loss,
}


# -----------------------------------------------------------------------------
# Dense per-pixel supervision over the GT instance masks


def _gt_class_select(field: Tensor, gt_mask: Tensor, k: int) -> Tensor:
    """The k channels of each pixel's GT class from a class-major NCHW field
    [B, k(C-1), H, W] -> [B, H, W, k]; background pixels give 0."""
    b, _, h, w = field.shape
    f = field.reshape(b, -1, k, h * w)
    cls = gt_mask.long().reshape(b, 1, 1, h * w)
    sel = torch.gather(f, 1, (cls - 1).clamp_min(0).expand(b, 1, k, h * w))[:, 0]
    sel = torch.where(cls[:, 0] > 0, sel, torch.zeros_like(sel))  # [B, k, HW]
    return sel.transpose(1, 2).reshape(b, h, w, k)


def dense_supervision(logits: Dict[str, Tensor], gt_mask: Tensor,
                      agg: Dict[str, Tensor], weights: Dict[str, float],
                      sample_weight: Optional[Tensor] = None,
                      sym_quat_mode: str = "swing"
                      ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Masked dense L1 losses on the raw head fields at the GT class
    channels, against targets painted from the GT instances: the
    hemisphere-canonical quaternion (for symmetric instances the swing
    representative, the raw one or nothing, by `sym_quat_mode`), unit
    vectors to the instance centre, log-depth and the scales.

    weights: {'quaternion', 'xy', 'z', 'scales'} -> weight; a term of weight
    0 is not computed. Returns (weighted total, logs)."""
    dev = gt_mask.device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    logs: Dict[str, Tensor] = {}
    if not any(weights.values()):
        return total, logs

    inst = agg["instance_masks"].float() * agg["valid"].float()[..., None, None]
    if sample_weight is not None:
        inst = inst * sample_weight.float()[:, None, None, None]
    fg = inst.sum(1)  # [B, H, W] (instances are disjoint)

    def paint(masks: Tensor, values: Tensor) -> Tensor:  # -> [B, H, W, D]
        return torch.einsum("bnhw,bnd->bhwd", masks, values)

    def masked_l1(pred: Tensor, target: Tensor, where: Tensor) -> Tensor:
        err = (pred - target).abs().sum(-1)
        return (err * where).sum() / where.sum().clamp_min(1.0)

    if weights.get("quaternion"):
        sym = agg["symmetric_ids"].float()[..., None]
        q_gt = geometry.quat_canonical(agg["quaternion"])
        q_masks = inst
        if sym_quat_mode == "full":
            q_target = q_gt
        elif sym_quat_mode == "swing":
            q_swing = geometry.quat_swing_canonical(agg["quaternion"])
            q_target = q_gt * (1.0 - sym) + q_swing * sym
        elif sym_quat_mode == "exclude":
            q_target = q_gt
            q_masks = inst * (1.0 - sym[..., 0])[:, :, None, None]
        else:
            raise NotImplementedError(
                f"DENSE_SYM_QUAT_MODE={sym_quat_mode!r} is invalid "
                "(expected full | swing | exclude)")
        pred = _gt_class_select(logits["quaternion"], gt_mask, 4)
        loss = masked_l1(pred, paint(q_masks, q_target), q_masks.sum(1))
        logs["quaternion/loss_dense"] = loss
        total = total + weights["quaternion"] * loss

    if weights.get("xy"):
        pred = _gt_class_select(logits["xy"], gt_mask, 2)
        _, h, w = gt_mask.shape
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
        centers = paint(inst, agg["xy"])  # [B, H, W, 2] (x, y)
        dvec = torch.stack([centers[..., 0] - xs, centers[..., 1] - ys], dim=-1)
        loss = masked_l1(pred, geometry.safe_normalize(dvec), fg)
        logs["xy/loss_dense"] = loss
        total = total + weights["xy"] * loss

    if weights.get("z"):
        pred = _gt_class_select(logits["z"], gt_mask, 1)
        logz = torch.log(agg["z"].clamp_min(1e-8))[..., None]
        loss = masked_l1(pred, paint(inst, logz), fg)
        logs["z/loss_dense"] = loss
        total = total + weights["z"] * loss

    if weights.get("scales"):
        pred = _gt_class_select(logits["scales"], gt_mask, 3)
        loss = masked_l1(pred, paint(inst, agg["scales"]), fg)
        logs["scales/loss_dense"] = loss
        total = total + weights["scales"] * loss

    logs["pose/dense_total"] = total
    return total, logs

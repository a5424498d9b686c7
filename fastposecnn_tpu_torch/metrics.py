"""Streaming pose and mask metrics as state dicts of tensors (counterpart
of the JAX package's `metrics.py`): a metric is (init, update, compute)
functions over a {correct, total} state, on the device of its inputs.

As in the JAX package, the running means accumulate (sum, count) for a
true mean; the thresholded AP metrics match the reference exactly. Inside
a process group (`parallel.mesh`), `mask_scores` and the pose metric
bank's updates are the global batch's: their counts are summed over the
ranks (the JAX package's `psum`, the reference's `dist_reduce_fx='sum'`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fastposecnn_tpu_torch import geometry
from fastposecnn_tpu_torch.parallel import mesh

State = Dict[str, torch.Tensor]


def zeros_state(device=None) -> State:
    return {"correct": torch.zeros((), device=device),
            "total": torch.zeros((), device=device)}


def ratio(state: State, scale: float = 100.0) -> torch.Tensor:
    return scale * state["correct"] / state["total"].clamp_min(1.0)


def mean(state: State) -> torch.Tensor:
    return state["correct"] / state["total"].clamp_min(1.0)


def _accumulate(state: State, values: torch.Tensor, hits: torch.Tensor,
                valid: torch.Tensor) -> State:
    valid = valid & torch.isfinite(values)
    return {
        "correct": state["correct"] + torch.where(valid, hits, 0.0).sum(),
        "total": state["total"] + valid.sum(),
    }


# -----------------------------------------------------------------------------
# Matched pose metrics (consume `gather_matched` payloads)


def _degrees(matched) -> torch.Tensor:
    return geometry.quat_distance_deg(matched["gt_quaternion"],
                                      matched["pred_quaternion"],
                                      matched["symmetric_ids"])


def _iou(matched, fpc_compat: bool = False) -> torch.Tensor:
    return geometry.asymmetric_3d_iou(matched["gt_RT"], matched["pred_RT"],
                                      matched["gt_scales"], matched["pred_scales"],
                                      fpc_compat=fpc_compat)


def _offset(matched) -> torch.Tensor:
    return geometry.offset_error_cm(matched["gt_T"], matched["pred_T"])


def update_degree_error_ap(state: State, matched, threshold_deg: float) -> State:
    """% of matches whose symmetry-aware quaternion distance is below the
    threshold."""
    d = _degrees(matched)
    return _accumulate(state, d, (d < threshold_deg).float(), matched["valid"])


def update_degree_error_mean(state: State, matched) -> State:
    d = _degrees(matched)
    return _accumulate(state, d, d, matched["valid"])


def update_degree_error_geodesic(state: State, matched) -> State:
    """True mean rotation angle."""
    d = geometry.geodesic_quat_distance_deg(matched["gt_quaternion"],
                                            matched["pred_quaternion"],
                                            matched["symmetric_ids"])
    return _accumulate(state, d, d, matched["valid"])


def update_iou3d_ap(state: State, matched, threshold: float,
                    fpc_compat: bool = False) -> State:
    iou = _iou(matched, fpc_compat)
    return _accumulate(state, iou, (iou > threshold).float(), matched["valid"])


def update_iou3d_mean(state: State, matched) -> State:
    iou = _iou(matched)
    return _accumulate(state, iou, iou * 100.0, matched["valid"])


def update_offset_ap(state: State, matched, threshold_cm: float) -> State:
    err = _offset(matched)
    return _accumulate(state, err, (err < threshold_cm).float(), matched["valid"])


def update_offset_error_mean(state: State, matched) -> State:
    err = _offset(matched)
    return _accumulate(state, err, err, matched["valid"])


# -----------------------------------------------------------------------------
# Pixel-wise mask metrics


def mask_scores(pred_mask: torch.Tensor, gt_mask: torch.Tensor, num_classes: int,
                sample_valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Micro-averaged dice / IoU / F1 over the foreground classes, and the
    pixel accuracy. `sample_valid` [B] leaves padded samples out."""
    if sample_valid is None:
        sv = torch.ones(pred_mask.shape[:1], dtype=torch.bool, device=pred_mask.device)
    else:
        sv = sample_valid.bool()
    svp = sv.reshape(sv.shape + (1,) * (pred_mask.ndim - 1))
    tp = fp = fn = 0
    for c in range(1, num_classes):
        p = (pred_mask == c) & svp
        g = (gt_mask == c) & svp
        tp = tp + (p & g).sum()
        fp = fp + (p & ~g).sum()
        fn = fn + (~p & g).sum()
    correct = ((pred_mask == gt_mask) & svp).float().sum()
    denom = sv.sum() * pred_mask[0].numel()
    if mesh.active():
        tp, fp, fn, correct, denom = mesh.sum_over_ranks([tp, fp, fn, correct, denom],
                                                         dtype=torch.float64)
    dice = 2 * tp / torch.clamp_min(torch.as_tensor(2 * tp + fp + fn), 1)
    iou = tp / torch.clamp_min(torch.as_tensor(tp + fp + fn), 1)
    return {"dice": dice, "iou": iou, "f1": dice,  # micro-F1 == dice
            "accuracy": correct / denom.clamp_min(1.0)}


# -----------------------------------------------------------------------------
# Metric bank: the standard suite


BANK = ("degree_error", "degree_error_geodesic", "degree_error_AP_5",
        "iou_3d_mAP_0.25", "iou_3d_accuracy", "offset_error_AP_5cm",
        "offset_error")


def init_pose_metric_bank(device=None) -> Dict[str, State]:
    return {name: zeros_state(device) for name in BANK}


def update_pose_metric_bank(bank: Dict[str, State], matched) -> Dict[str, State]:
    """`bank` updated with the matched instances (of the global batch inside
    a process group)."""
    if mesh.active():
        delta = _update_bank(init_pose_metric_bank(bank["degree_error"]["total"].device),
                             matched)
        summed = iter(mesh.sum_over_ranks(
            [v for state in delta.values() for v in state.values()], dtype=torch.float64))
        return {name: {k: v + next(summed) for k, v in state.items()}
                for name, state in bank.items()}
    return _update_bank(bank, matched)


def _update_bank(bank: Dict[str, State], matched) -> Dict[str, State]:
    return {
        "degree_error": update_degree_error_mean(bank["degree_error"], matched),
        "degree_error_geodesic": update_degree_error_geodesic(
            bank["degree_error_geodesic"], matched),
        "degree_error_AP_5": update_degree_error_ap(
            bank["degree_error_AP_5"], matched, 5.0),
        "iou_3d_mAP_0.25": update_iou3d_ap(bank["iou_3d_mAP_0.25"], matched, 0.25),
        "iou_3d_accuracy": update_iou3d_mean(bank["iou_3d_accuracy"], matched),
        "offset_error_AP_5cm": update_offset_ap(
            bank["offset_error_AP_5cm"], matched, 5.0),
        "offset_error": update_offset_error_mean(bank["offset_error"], matched),
    }


def compute_pose_metric_bank(bank: Dict[str, State]) -> Dict[str, torch.Tensor]:
    return {
        "degree_error": mean(bank["degree_error"]),
        "degree_error_geodesic": mean(bank["degree_error_geodesic"]),
        "degree_error_AP_5": ratio(bank["degree_error_AP_5"]),
        "iou_3d_mAP_0.25": ratio(bank["iou_3d_mAP_0.25"]),
        "iou_3d_accuracy": mean(bank["iou_3d_accuracy"]),
        "offset_error_AP_5cm": ratio(bank["offset_error_AP_5cm"]),
        "offset_error": mean(bank["offset_error"]),
    }

"""Host-side (numpy, native float64) evaluation error math: a copy of the
JAX package's `eval_host.py` (the port imports nothing of that package).

The reference computes its symmetric quaternion distance in double
precision (FPC/lib/gpu_tensor_funcs.py:797 `.double()`), so phase A of
`cli/evaluate.py` brings the matched payload to the host and computes the
errors here in float64. Semantics are those of the `geometry.py` functions
of the same names, including the `fpc_compat` 3D-IoU quirk; see those
docstrings (gpu_tensor_funcs.py:411-476, 503-565, 718-799).
"""

from __future__ import annotations

import functools

import numpy as np


def _normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    norm = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.where(norm > 0, norm, 1.0)


@functools.lru_cache(maxsize=2)
def _symmetry_rotation_quats(num_steps: int) -> np.ndarray:
    """(cos(d/2), 0, sin(d/2), 0) for d in 0..num_steps-1 degrees (f64)."""
    half = np.deg2rad(np.arange(num_steps) * (360.0 / num_steps)) / 2
    zeros = np.zeros(num_steps)
    return np.stack([np.cos(half), zeros, np.sin(half), zeros], axis=-1)


def _quat_multiply_wxyz(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    out = np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )
    return _normalize(out)


def _raw_quat_distance_deg(q0: np.ndarray, q1: np.ndarray) -> np.ndarray:
    d_minus = np.linalg.norm(q0 - q1, axis=-1)
    d_plus = np.linalg.norm(q0 + q1, axis=-1)
    return np.rad2deg(np.minimum(d_minus, d_plus))


def quat_distance_deg(
    q0: np.ndarray, q1: np.ndarray, symmetric: np.ndarray,
    num_steps: int = 360,
) -> np.ndarray:
    """f64 mirror of geometry.quat_distance_deg."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    raw = _raw_quat_distance_deg(q0, q1)
    rot_q = _symmetry_rotation_quats(num_steps)
    rot_e_q1 = _quat_multiply_wxyz(q1[..., None, :], rot_q)
    sym = np.min(_raw_quat_distance_deg(q0[..., None, :], rot_e_q1), axis=-1)
    out = np.where(np.asarray(symmetric) != 0, sym, raw)
    assert out.dtype == np.float64
    return out


def geodesic_quat_distance_deg(
    q0: np.ndarray, q1: np.ndarray, symmetric: np.ndarray,
    num_steps: int = 360,
) -> np.ndarray:
    """f64 mirror of geometry.geodesic_quat_distance_deg (TRUE rotation
    angle; the parity metric above reads chord length as radians and
    understates large errors — random predictions read as ~49 deg)."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)

    def angle(dot):
        return np.rad2deg(2.0 * np.arccos(np.clip(np.abs(dot), 0.0, 1.0)))

    raw = angle(np.sum(q0 * q1, axis=-1))
    rot_q = _symmetry_rotation_quats(num_steps)
    rot_q1 = _quat_multiply_wxyz(q1[..., None, :], rot_q)
    sym = np.min(angle(np.sum(q0[..., None, :] * rot_q1, axis=-1)), axis=-1)
    out = np.where(np.asarray(symmetric) != 0, sym, raw)
    assert out.dtype == np.float64
    return out


_UNIT_BBOX = (
    np.array(
        [
            [1, 1, 1], [1, 1, -1], [-1, 1, 1], [-1, 1, -1],
            [1, -1, 1], [1, -1, -1], [-1, -1, 1], [-1, -1, -1],
        ],
        dtype=np.float64,
    )
    / 2.0
)


def _invert_RT(RT: np.ndarray) -> np.ndarray:
    R = RT[..., :3, :3]
    t = RT[..., :3, 3]
    Rt = np.swapaxes(R, -1, -2)
    top = np.concatenate(
        [Rt, -np.einsum("...ij,...j->...i", Rt, t)[..., None]], axis=-1
    )
    bottom = np.broadcast_to(
        np.array([0.0, 0.0, 0.0, 1.0]), top.shape[:-2] + (1, 4)
    )
    return np.concatenate([top, bottom], axis=-2)


def _camera_to_world(points: np.ndarray, RT: np.ndarray) -> np.ndarray:
    ones = np.ones(points.shape[:-2] + (1, points.shape[-1]))
    homo = np.concatenate([points, ones], axis=-2)
    world = np.einsum("...ij,...jn->...in", _invert_RT(RT), homo)
    return world[..., :-1, :] / world[..., -1:, :]



def asymmetric_3d_iou(
    RT_1: np.ndarray, RT_2: np.ndarray,
    scales_1: np.ndarray, scales_2: np.ndarray,
    fpc_compat: bool = False,
) -> np.ndarray:
    """f64 mirror of geometry.asymmetric_3d_iou (incl. fpc_compat quirk)."""
    RT_1 = np.asarray(RT_1, np.float64)
    RT_2 = np.asarray(RT_2, np.float64)
    s1 = np.asarray(scales_1, np.float64)
    s2 = np.asarray(scales_2, np.float64)
    c1 = np.swapaxes(_UNIT_BBOX * s1[..., None, :], -1, -2)  # [..., 3, 8]
    c2 = np.swapaxes(_UNIT_BBOX * s2[..., None, :], -1, -2)
    b1 = _camera_to_world(c1, RT_1)
    b2 = _camera_to_world(c2, RT_2)
    axis = -2 if fpc_compat else -1
    b1_min, b1_max = np.min(b1, axis=axis), np.max(b1, axis=axis)
    b2_min, b2_max = np.min(b2, axis=axis), np.max(b2, axis=axis)
    extent = np.minimum(b1_max, b2_max) - np.maximum(b1_min, b2_min)
    intersection = np.where(
        np.min(extent, axis=-1) < 0, 0.0, np.prod(extent, axis=-1)
    )
    union = (
        np.prod(b1_max - b1_min, axis=-1)
        + np.prod(b2_max - b2_min, axis=-1)
        - intersection
    )
    out = intersection / union
    assert out.dtype == np.float64
    return out


def offset_error_cm(gt_T: np.ndarray, pred_T: np.ndarray) -> np.ndarray:
    """f64 mirror of geometry.offset_error_cm."""
    out = np.linalg.norm(
        np.asarray(gt_T, np.float64) - np.asarray(pred_T, np.float64), axis=-1
    ) * 10.0
    assert out.dtype == np.float64
    return out


def calculate_ap(values, valid, thresholds, greater_is_better):
    """Numpy mirror of geometry.calculate_ap, in float64."""
    values = np.asarray(values, np.float64)
    valid = np.asarray(valid, bool) & np.isfinite(values)
    thresholds = np.asarray(thresholds, np.float64)
    if greater_is_better:
        hit = values[None, :] > thresholds[:, None]
    else:
        hit = values[None, :] < thresholds[:, None]
    hit = hit & valid[None, :]
    denom = max(int(valid.sum()), 1)
    return hit.sum(axis=1) / denom


def calculate_joint_ap(values_a, values_b, valid, thresholds_a, thresholds_b):
    """Numpy mirror of geometry.calculate_joint_ap (5deg5cm-style)."""
    a = np.asarray(values_a, np.float64)
    b = np.asarray(values_b, np.float64)
    valid = np.asarray(valid, bool) & np.isfinite(a) & np.isfinite(b)
    ta = np.asarray(thresholds_a, np.float64)
    tb = np.asarray(thresholds_b, np.float64)
    hit = (a[None, :] < ta[:, None]) & (b[None, :] < tb[:, None]) & valid[None, :]
    denom = max(int(valid.sum()), 1)
    return hit.sum(axis=1) / denom

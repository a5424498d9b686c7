"""Geometry: quaternions, rigid transforms, 3D IoU, pose errors and AP
curves (counterpart of the JAX package's `geometry.py`), batched torch
functions on any device, float32 unless the inputs are float64.

Quaternions are (x, y, z, w), scipy's `as_quat()` order. The symmetric
distance feeds xyzw-stored quaternions through a product that treats
component 0 as the real part: a quirk of the reference, kept for metric
parity.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def safe_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2-normalize along `dim`; a zero vector stays zero (no NaN)."""
    norm_sq = torch.sum(x * x, dim=dim, keepdim=True)
    is_zero = norm_sq <= 0.0
    inv = torch.rsqrt(torch.where(is_zero, torch.ones_like(norm_sq), norm_sq))
    return x * torch.where(is_zero, torch.ones_like(inv), inv)


def homogenize(points: torch.Tensor) -> torch.Tensor:
    """[..., 3, N] cartesian -> [..., 4, N] homogeneous."""
    ones = torch.ones(points.shape[:-2] + (1, points.shape[-1]),
                      dtype=points.dtype, device=points.device)
    return torch.cat([points, ones], dim=-2)


def dehomogenize(points: torch.Tensor) -> torch.Tensor:
    """[..., 4, N] -> [..., 3, N], dividing by the last row."""
    return points[..., :-1, :] / points[..., -1:, :]


# -----------------------------------------------------------------------------
# Quaternions (xyzw storage order)


def quat_canonical(q: torch.Tensor) -> torch.Tensor:
    """Flip each quaternion to the hemisphere where its largest-magnitude
    component is positive (q and -q are one rotation; a regression target
    must live on one hemisphere)."""
    comp = torch.gather(q, -1, torch.argmax(q.abs(), dim=-1, keepdim=True))
    return q * torch.where(comp >= 0, 1.0, -1.0)


def quat_swing_canonical(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Remove the camera-y twist the symmetric degree metrics forgive, then
    hemisphere-canonicalize: q = t (x) s with t ~ (0, q_y, 0, q_w); returns
    quat_canonical(s), whose y component is 0 up to rounding. At
    q_y = q_w = 0, t falls back to identity."""
    x, y, z, w = q.unbind(-1)
    n = torch.sqrt(y * y + w * w)
    safe = n > eps
    ty = torch.where(safe, y / n.clamp_min(eps), 0.0)
    tw = torch.where(safe, w / n.clamp_min(eps), 1.0)
    sx = tw * x - ty * z
    sy = tw * y - ty * w
    sz = tw * z + ty * x
    sw = tw * w + ty * y
    return quat_canonical(torch.stack([sx, sy, sz, sw], dim=-1))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Batched quaternion (xyzw) -> rotation matrix [..., 3, 3], in the
    transposed layout of the reference's `quats_2_rotation_matrix`."""
    q1, q2, q3, q4 = q.unbind(-1)
    q1_2, q2_2, q3_2, q4_2 = q1 * q1, q2 * q2, q3 * q3, q4 * q4
    r00 = q1_2 - q2_2 - q3_2 + q4_2
    r01 = 2 * (q1 * q2 - q3 * q4)
    r02 = 2 * (q1 * q3 + q2 * q4)
    r10 = 2 * (q1 * q2 + q3 * q4)
    r11 = -q1_2 + q2_2 - q3_2 + q4_2
    r12 = 2 * (q2 * q3 - q1 * q4)
    r20 = 2 * (q1 * q3 - q2 * q4)
    r21 = 2 * (q2 * q3 + q1 * q4)
    r22 = -q1_2 - q2_2 + q3_2 + q4_2
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Batched rotation matrix [..., 3, 3] -> quaternion (xyzw), by
    branch-free Shepperd's method (all four candidates computed, one
    selected); equal to scipy's up to sign."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _q(a, b, c, d):
        return torch.stack([a, b, c, d], dim=-1)

    def _s(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12)) * 2

    sw = _s(1.0 + tr)
    qw = _q((m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, 0.25 * sw)
    sx = _s(1.0 + m00 - m11 - m22)
    qx = _q(0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx)
    sy = _s(1.0 - m00 + m11 - m22)
    qy = _q((m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy, (m02 - m20) / sy)
    sz = _s(1.0 - m00 - m11 + m22)
    qz = _q((m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz, (m10 - m01) / sz)

    cond_w = (tr > 0)[..., None]
    cond_x = ((m00 > m11) & (m00 > m22))[..., None]
    cond_y = (m11 > m22)[..., None]
    q = torch.where(cond_w, qw,
                    torch.where(cond_x, qx, torch.where(cond_y, qy, qz)))
    return safe_normalize(q)


def quat_raw_multiply_wxyz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product treating component 0 as the real part."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    ow = aw * bw - ax * bx - ay * by - az * bz
    ox = aw * bx + ax * bw + ay * bz - az * by
    oy = aw * by - ax * bz + ay * bw + az * bx
    oz = aw * bz + ax * by - ay * bx + az * bw
    return torch.stack([ow, ox, oy, oz], dim=-1)


def quat_multiply_wxyz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalized Hamilton product."""
    return safe_normalize(quat_raw_multiply_wxyz(a, b))


@functools.lru_cache(maxsize=4)
def _symmetry_rotation_quats_np(num_steps: int) -> np.ndarray:
    """(cos(d/2), 0, sin(d/2), 0) for d in 0..num_steps-1 steps of the
    circle, in float64."""
    half = np.deg2rad(np.arange(0, num_steps) * (360.0 / num_steps)) / 2
    zeros = np.zeros_like(half)
    return np.stack([np.cos(half), zeros, np.sin(half), zeros], axis=-1)


def _symmetry_rotation_quats(num_steps: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_symmetry_rotation_quats_np(num_steps)).to(
        dtype=like.dtype, device=like.device)


def raw_quat_distance_deg(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """min(||q0 - q1||, ||q0 + q1||) read as radians, in degrees (the
    reference's chord-as-angle metric)."""
    d_minus = torch.linalg.vector_norm(q0 - q1, dim=-1)
    d_plus = torch.linalg.vector_norm(q0 + q1, dim=-1)
    return torch.rad2deg(torch.minimum(d_minus, d_plus))


def symmetric_quat_distance_deg(q0: torch.Tensor, q1: torch.Tensor,
                                num_steps: int = 360) -> torch.Tensor:
    """Smallest raw distance from q0 to q1 rotated by each of `num_steps`
    y-axis rotations."""
    rot_q = _symmetry_rotation_quats(num_steps, q0)
    rot_e_q1 = quat_multiply_wxyz(q1[..., None, :], rot_q)
    return raw_quat_distance_deg(q0[..., None, :], rot_e_q1).amin(dim=-1)


def quat_distance_deg(q0: torch.Tensor, q1: torch.Tensor,
                      symmetric: torch.Tensor, num_steps: int = 360) -> torch.Tensor:
    """Per-instance degree distance, symmetric where `symmetric` != 0."""
    raw = raw_quat_distance_deg(q0, q1)
    sym = symmetric_quat_distance_deg(q0, q1, num_steps)
    return torch.where(symmetric != 0, sym, raw)


def geodesic_quat_distance_deg(q0: torch.Tensor, q1: torch.Tensor,
                               symmetric: torch.Tensor,
                               num_steps: int = 360) -> torch.Tensor:
    """True rotation angle 2*acos(|<q0, q1>|) in degrees, with the same
    min over y-axis rotations for symmetric instances."""
    def angle(dot):
        return torch.rad2deg(
            2.0 * torch.arccos(torch.clamp(dot.abs(), 0.0, 1.0 - 1e-7)))

    raw = angle(torch.sum(q0 * q1, dim=-1))
    rot_q1 = quat_multiply_wxyz(q1[..., None, :],
                                _symmetry_rotation_quats(num_steps, q0))
    sym = angle(torch.sum(q0[..., None, :] * rot_q1, dim=-1)).amin(dim=-1)
    return torch.where(symmetric != 0, sym, raw)


# -----------------------------------------------------------------------------
# Rigid transforms / RT reconstruction


def backproject_to_translation(
    xy: torch.Tensor, z_mm: torch.Tensor, inv_intrinsics: torch.Tensor
) -> torch.Tensor:
    """Pixel (x, y) + depth z [mm] -> camera-frame translation T [m]:
    T = K^-1 @ (x*z, y*z, z) / 1000."""
    z_m = z_mm / 1000.0
    xyz = torch.cat([xy * z_m, z_m], dim=-1)
    return xyz @ inv_intrinsics.to(xyz.dtype).T


def assemble_RT(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """RT = [[R, -R @ T], [0, 0, 0, 1]] (the closed-form inverse of the
    reference's [[R^-1, T], [0, 0, 0, 1]])."""
    top = torch.cat([R, -(R @ T[..., None])], dim=-1)
    # [0, 0, 0, 1], made on the device: a host-to-device copy would wait
    # for the stream.
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3]
    bottom = bottom.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def invert_RT(RT: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform [..., 4, 4]."""
    Rt = RT[..., :3, :3].transpose(-1, -2)
    t = RT[..., :3, 3:]
    top = torch.cat([Rt, -(Rt @ t)], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=RT.dtype, device=RT.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def batch_get_RT(
    quat: torch.Tensor, xy: torch.Tensor, z_mm: torch.Tensor,
    inv_intrinsics: torch.Tensor,
):
    """(quat, 2D center, depth [..., 1]) -> (R, T, RT), all batched."""
    T = backproject_to_translation(xy, z_mm, inv_intrinsics)
    R = quat_to_rotmat(safe_normalize(quat))
    return R, T, assemble_RT(R, T)


def transform_camera_to_world(points: torch.Tensor, RT: torch.Tensor) -> torch.Tensor:
    """Camera coordinates [..., 3, N] through inv(RT) -> world [..., 3, N]."""
    return dehomogenize(invert_RT(RT) @ homogenize(points))


def project_to_image(points: torch.Tensor, RT: torch.Tensor,
                     intrinsics: torch.Tensor) -> torch.Tensor:
    """Object-frame 3D points [..., 3, N] -> pixel (x, y) [..., 2, N]
    (not quantized)."""
    cam = transform_camera_to_world(points, RT)
    proj = intrinsics.to(cam.dtype) @ cam
    return proj[..., :2, :] / proj[..., 2:3, :]


# -----------------------------------------------------------------------------
# 3D bounding boxes and IoU

_UNIT_BBOX = np.array(
    [[1, 1, 1], [1, 1, -1], [-1, 1, 1], [-1, 1, -1],
     [1, -1, 1], [1, -1, -1], [-1, -1, 1], [-1, -1, -1]],
    dtype=np.float32,
) / 2.0


def get_3d_bbox(scale: torch.Tensor, shift: float = 0.0) -> torch.Tensor:
    """scale [..., 3] -> bbox corners [..., 3, 8]."""
    unit = torch.from_numpy(_UNIT_BBOX).to(dtype=scale.dtype, device=scale.device)
    return (unit * scale[..., None, :] + shift).transpose(-1, -2)


def asymmetric_3d_iou(RT_1: torch.Tensor, RT_2: torch.Tensor,
                      scales_1: torch.Tensor, scales_2: torch.Tensor,
                      fpc_compat: bool = False) -> torch.Tensor:
    """Axis-aligned 3D IoU of two scaled boxes after the camera->world
    transform. `fpc_compat=True` keeps the reference's quirk of reducing
    its [3, 8] corner matrix over the coordinate axis (min/max/prod over 8
    per-corner values)."""
    b1 = transform_camera_to_world(get_3d_bbox(scales_1), RT_1)  # [..., 3, 8]
    b2 = transform_camera_to_world(get_3d_bbox(scales_2), RT_2)
    dim = -2 if fpc_compat else -1
    b1_min, b1_max = b1.amin(dim=dim), b1.amax(dim=dim)
    b2_min, b2_max = b2.amin(dim=dim), b2.amax(dim=dim)
    extent = torch.minimum(b1_max, b2_max) - torch.maximum(b1_min, b2_min)
    intersection = torch.where(extent.amin(dim=-1) < 0, 0.0,
                               torch.prod(extent, dim=-1))
    union = (torch.prod(b1_max - b1_min, dim=-1)
             + torch.prod(b2_max - b2_min, dim=-1) - intersection)
    return intersection / union


def offset_error_cm(gt_T: torch.Tensor, pred_T: torch.Tensor) -> torch.Tensor:
    """||gt_T - pred_T|| * 10 (metres -> the reference's 'cm' unit)."""
    return torch.linalg.vector_norm(gt_T - pred_T, dim=-1) * 10.0


# -----------------------------------------------------------------------------
# AP curves (masked, fixed shape)


def calculate_ap(values: torch.Tensor, valid: torch.Tensor,
                 thresholds: torch.Tensor, greater_is_better: bool) -> torch.Tensor:
    """Fraction of valid, finite entries passing each threshold: [T]."""
    valid = valid & torch.isfinite(values)
    if greater_is_better:
        hit = values[None, :] > thresholds[:, None]
    else:
        hit = values[None, :] < thresholds[:, None]
    hit = hit & valid[None, :]
    return hit.sum(dim=1) / valid.sum().clamp_min(1)


def calculate_joint_ap(values_a: torch.Tensor, values_b: torch.Tensor,
                       valid: torch.Tensor, thresholds_a: torch.Tensor,
                       thresholds_b: torch.Tensor) -> torch.Tensor:
    """Joint less-than AP (e.g. 5 degrees and 5 cm): [T]."""
    valid = valid & torch.isfinite(values_a) & torch.isfinite(values_b)
    hit = ((values_a[None, :] < thresholds_a[:, None])
           & (values_b[None, :] < thresholds_b[:, None]) & valid[None, :])
    return hit.sum(dim=1) / valid.sum().clamp_min(1)

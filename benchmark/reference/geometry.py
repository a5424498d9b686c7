"""Geometry of the plain reference: quaternions and rigid transforms, the
functions of `fastposecnn_tpu_torch/geometry.py` that the stages and losses
use, copied and frozen. Batched torch functions on any device, float32
unless the inputs are float64.

Quaternions are (x, y, z, w), scipy's `as_quat()` order. The symmetric
quaternion loss feeds xyzw-stored quaternions through a product that
treats component 0 as the real part: a quirk of the reference, kept.
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


def batch_get_RT(
    quat: torch.Tensor, xy: torch.Tensor, z_mm: torch.Tensor,
    inv_intrinsics: torch.Tensor,
):
    """(quat, 2D center, depth [..., 1]) -> (R, T, RT), all batched."""
    T = backproject_to_translation(xy, z_mm, inv_intrinsics)
    R = quat_to_rotmat(safe_normalize(quat))
    return R, T, assemble_RT(R, T)

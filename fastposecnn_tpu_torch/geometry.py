"""Geometry the inference path needs: the counterparts of the JAX package's
`geometry.py` `safe_normalize` (:31), `quat_to_rotmat` (:126),
`backproject_to_translation` (:299), `assemble_RT` (:311) and
`batch_get_RT` (:342).

Quaternions are (x, y, z, w), scipy's `as_quat()` order.
"""

from __future__ import annotations

import torch


def safe_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2-normalize along `dim`; a zero vector stays zero (no NaN)."""
    norm_sq = torch.sum(x * x, dim=dim, keepdim=True)
    is_zero = norm_sq <= 0.0
    inv = torch.rsqrt(torch.where(is_zero, torch.ones_like(norm_sq), norm_sq))
    return x * torch.where(is_zero, torch.ones_like(inv), inv)


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
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
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

"""Port parity for the evaluation geometry: quaternion canonicalization and
products, the raw, symmetric and geodesic rotation distances, rigid
transforms, 3D IoU (both `fpc_compat` settings), offsets and AP curves of
`fastposecnn_tpu_torch.geometry` against `fastposecnn_tpu.geometry`, and the
port's float64 `eval_host` copy against the JAX package's.

Tolerances: float32 fields and transforms atol 2e-4 / rtol 1e-4; chord
distances atol 1e-3 degrees; geodesic angles atol 0.05 degrees (an ulp of a
dot product near 1 moves arccos by up to ~0.04 degrees); AP curves and the
float64 host copy exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from fastposecnn_tpu import eval_host as jax_eval_host
from fastposecnn_tpu import geometry as jg
from fastposecnn_tpu_torch import eval_host
from fastposecnn_tpu_torch import geometry as tg

ATOL, RTOL = 2e-4, 1e-4


def quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def pairs(rng, n=64):
    """GT quaternions and predictions at small, medium and large rotation
    errors, one exactly equal, one negated, and symmetric flags."""
    q0 = quats(rng, n)
    err = Rotation.from_rotvec(rng.normal(size=(n, 3)) * np.repeat(
        [0.01, 0.3, 2.0, 0.0], n // 4)[:, None])
    q1 = (err * Rotation.from_quat(q0)).as_quat().astype(np.float32)
    q1[1] = -q0[1]
    sym = (rng.random(n) > 0.5).astype(np.int32)
    return q0, q1, sym


def rts(rng, n):
    R = Rotation.from_quat(quats(rng, n)).as_matrix()
    T = rng.uniform([-0.3, -0.3, 0.5], [0.3, 0.3, 2.0], size=(n, 3))
    RT = np.zeros((n, 4, 4))
    RT[:, :3, :3] = R
    RT[:, :3, 3] = -np.einsum("nij,nj->ni", R, T)
    RT[:, 3, 3] = 1.0
    return RT.astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_quaternion_helpers_match_jax(rng):
    q = quats(rng, 200)
    q[:20, 1] = 0.0
    q[:5, 3] = 0.0  # q_y = q_w = 0 on five: the swing's identity fallback
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    for name in ("quat_canonical", "quat_swing_canonical"):
        np.testing.assert_allclose(getattr(tg, name)(t(q)).numpy(),
                                   np.asarray(getattr(jg, name)(jnp.asarray(q))),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    a, b = quats(rng, 50), quats(rng, 50)
    for name in ("quat_raw_multiply_wxyz", "quat_multiply_wxyz"):
        np.testing.assert_allclose(getattr(tg, name)(t(a), t(b)).numpy(),
                                   np.asarray(getattr(jg, name)(jnp.asarray(a), jnp.asarray(b))),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    R = Rotation.from_quat(q).as_matrix().astype(np.float32)
    got = tg.rotmat_to_quat(t(R)).numpy()
    np.testing.assert_allclose(got, np.asarray(jg.rotmat_to_quat(jnp.asarray(R))),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.abs((got * q).sum(-1)), 1.0, atol=1e-5)


def test_rotation_distances_match_jax(rng):
    q0, q1, sym = pairs(rng)
    j0, j1, js = jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(sym)
    for name, atol in (("raw_quat_distance_deg", 1e-3),
                       ("symmetric_quat_distance_deg", 1e-3)):
        np.testing.assert_allclose(getattr(tg, name)(t(q0), t(q1)).numpy(),
                                   np.asarray(getattr(jg, name)(j0, j1)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tg.quat_distance_deg(t(q0), t(q1), t(sym)).numpy(),
                               np.asarray(jg.quat_distance_deg(j0, j1, js)), atol=1e-3)
    got = tg.geodesic_quat_distance_deg(t(q0), t(q1), t(sym)).numpy()
    np.testing.assert_allclose(got, np.asarray(jg.geodesic_quat_distance_deg(j0, j1, js)),
                               atol=0.05)
    # The float64 host copy equals the JAX package's host code exactly, and
    # the float32 geometry comes within 0.1 degrees of it (the float32
    # geodesic clips |dot| at 1 - 1e-7, so equal rotations read 0.051 deg).
    for name in ("quat_distance_deg", "geodesic_quat_distance_deg"):
        want = getattr(jax_eval_host, name)(q0, q1, sym)
        np.testing.assert_array_equal(getattr(eval_host, name)(q0, q1, sym), want)
        np.testing.assert_allclose(got if "geodesic" in name else
                                   tg.quat_distance_deg(t(q0), t(q1), t(sym)).numpy(),
                                   want, atol=0.1)


def test_rigid_transforms_match_jax(rng):
    RT = rts(rng, 10)
    pts = rng.normal(size=(10, 3, 8)).astype(np.float32) * 0.2
    K = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]], np.float32)
    jR, jp = jnp.asarray(RT), jnp.asarray(pts)
    checks = {
        "invert_RT": (tg.invert_RT(t(RT)), jg.invert_RT(jR)),
        "transform_camera_to_world": (tg.transform_camera_to_world(t(pts), t(RT)),
                                      jg.transform_camera_to_world(jp, jR)),
        "project_to_image": (tg.project_to_image(t(pts), t(RT), t(K)),
                             jg.project_to_image(jp, jR, jnp.asarray(K))),
        "get_3d_bbox": (tg.get_3d_bbox(t(pts[:, :, 0])), jg.get_3d_bbox(jp[:, :, 0])),
    }
    for name, (got, want) in checks.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("fpc_compat", [False, True])
def test_3d_iou_matches_jax(rng, fpc_compat):
    n = 40
    RT1 = rts(rng, n)
    RT2 = RT1.copy()
    RT2[:, :3, 3] += rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    RT2[::4, :3, 3] += 5.0  # far apart: no overlap
    s1 = rng.uniform(0.05, 0.4, size=(n, 3)).astype(np.float32)
    s2 = (s1 * rng.uniform(0.8, 1.2, size=(n, 3))).astype(np.float32)
    got = tg.asymmetric_3d_iou(t(RT1), t(RT2), t(s1), t(s2), fpc_compat=fpc_compat)
    want = jg.asymmetric_3d_iou(jnp.asarray(RT1), jnp.asarray(RT2), jnp.asarray(s1),
                                jnp.asarray(s2), fpc_compat=fpc_compat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    host = eval_host.asymmetric_3d_iou(RT1, RT2, s1, s2, fpc_compat=fpc_compat)
    np.testing.assert_array_equal(
        host, jax_eval_host.asymmetric_3d_iou(RT1, RT2, s1, s2, fpc_compat=fpc_compat))
    np.testing.assert_allclose(got.numpy(), host, atol=ATOL, rtol=RTOL)
    assert (host > 0.3).sum() > n // 4 and (host == 0).sum() >= 1


def test_offsets_and_aps_match_jax(rng):
    gt_T, pred_T = rng.normal(size=(2, 30, 3)).astype(np.float32)
    np.testing.assert_allclose(tg.offset_error_cm(t(gt_T), t(pred_T)).numpy(),
                               np.asarray(jg.offset_error_cm(jnp.asarray(gt_T),
                                                             jnp.asarray(pred_T))),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(eval_host.offset_error_cm(gt_T, pred_T),
                                  jax_eval_host.offset_error_cm(gt_T, pred_T))
    a = (rng.random(60) * 20).astype(np.float32)
    b = (rng.random(60) * 12).astype(np.float32)
    a[3], b[7] = np.nan, np.inf
    valid = rng.random(60) > 0.2
    thr = np.linspace(0, 20, 50).astype(np.float32)
    for greater in (True, False):
        got = tg.calculate_ap(t(a), t(valid), t(thr), greater).numpy()
        want = jg.calculate_ap(jnp.asarray(a), jnp.asarray(valid), jnp.asarray(thr), greater)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
        np.testing.assert_array_equal(eval_host.calculate_ap(a, valid, thr, greater),
                                      jax_eval_host.calculate_ap(a, valid, thr, greater))
    ta, tb = np.array([5.0, 10.0, 10.0], np.float32), np.array([5.0, 5.0, 10.0], np.float32)
    got = tg.calculate_joint_ap(t(a), t(b), t(valid), t(ta), t(tb)).numpy()
    want = jg.calculate_joint_ap(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid),
                                 jnp.asarray(ta), jnp.asarray(tb))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(
        eval_host.calculate_joint_ap(a, b, valid, ta, tb),
        jax_eval_host.calculate_joint_ap(a, b, valid, ta, tb))
    assert 0 < got[0] < got[2] < 1

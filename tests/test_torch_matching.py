"""Port parity for instance matching, the matched payload, the pose metric
bank and the mask scores: `fastposecnn_tpu_torch.ops.matching` and
`fastposecnn_tpu_torch.metrics` against the JAX package on the same seeded
inputs (CPU).

Tolerances: IoUs, match indices, validity, the gathered payload and the
hit and instance counts of the thresholded AP metrics exactly equal; AP
percentages and mask scores within rtol 1e-6; the mean metrics (degrees,
IoU percent, cm) within rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu import metrics as jm
from fastposecnn_tpu.ops import matching as jmatch
from fastposecnn_tpu_torch import metrics as tm
from fastposecnn_tpu_torch.ops import matching as tmatch

KEYS = ("quaternion", "scales", "z", "xy", "T", "R", "RT")


def instance_sets(rng, b=2, g=5, n=6, h=24, w=32):
    """GT and predicted instances: overlapping random boxes (so a GT meets
    several predictions, with exact IoU ties), mixed classes and padded
    slots, and a field per payload key."""
    def boxes(k):
        m = np.zeros((b, k, h, w), np.float32)
        for bi in range(b):
            for i in range(k):
                y, x = rng.integers(0, h - 6), rng.integers(0, w - 8)
                m[bi, i, y:y + rng.integers(3, 10), x:x + rng.integers(3, 12)] = 1.0
        return m

    def fields(k):
        return {"quaternion": rng.normal(size=(b, k, 4)), "scales": rng.random((b, k, 3)),
                "z": rng.random((b, k)) * 1000, "xy": rng.random((b, k, 2)) * 30,
                "T": rng.normal(size=(b, k, 3)), "R": rng.normal(size=(b, k, 3, 3)),
                "RT": rng.normal(size=(b, k, 4, 4))}

    gts = {"instance_masks": boxes(g), "class_ids": rng.integers(1, 3, (b, g)),
           "valid": rng.random((b, g)) > 0.2, "symmetric_ids": rng.integers(0, 2, (b, g)),
           **fields(g)}
    preds = {"instance_masks": boxes(n), "class_ids": rng.integers(1, 3, (b, n)),
             "valid": rng.random((b, n)) > 0.2, **fields(n)}
    preds["instance_masks"][0, 3] = gts["instance_masks"][0, 0]  # IoU 1
    preds["instance_masks"][1, 4] = preds["instance_masks"][1, 1]  # a tie
    preds["class_ids"][1, 4] = preds["class_ids"][1, 1]
    cast = {"class_ids": np.int32, "symmetric_ids": np.int32, "valid": bool}
    out = []
    for d in (gts, preds):
        d = {k: np.asarray(v, cast.get(k, np.float32)) for k, v in d.items()}
        out.append(({k: jnp.asarray(v) for k, v in d.items()},
                    {k: torch.from_numpy(v) for k, v in d.items()}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_instances_matches_jax(seed):
    (gj, gt), (pj, pt) = instance_sets(np.random.default_rng(seed))
    want = jmatch.match_instances(pj, gj)
    got = tmatch.match_instances(pt, gt)
    for key in ("pred_idx", "valid", "iou"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(
        tmatch.mask_iou_matrix(gt["instance_masks"], pt["instance_masks"]).numpy(),
        np.asarray(jmatch.mask_iou_matrix(gj["instance_masks"], pj["instance_masks"])))
    assert got["valid"].any()


@pytest.mark.parametrize("fill_missing", [False, True])
def test_gather_matched_matches_jax(fill_missing):
    (gj, gt), (pj, pt) = instance_sets(np.random.default_rng(4))
    want = jmatch.gather_matched(pj, gj, jmatch.match_instances(pj, gj), keys=KEYS,
                                 fill_missing=fill_missing)
    got = tmatch.gather_matched(pt, gt, tmatch.match_instances(pt, gt), keys=KEYS,
                                fill_missing=fill_missing)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def _matched(rng):
    """A matched payload of near and far predictions (unit quaternions,
    rigid RTs)."""
    from scipy.spatial.transform import Rotation

    b, g = 3, 6
    q = Rotation.random(b * g, random_state=1).as_quat().reshape(b, g, 4)
    noise = Rotation.from_rotvec(rng.normal(size=(b * g, 3)) * 0.08)
    qp = (noise * Rotation.from_quat(q.reshape(-1, 4))).as_quat().reshape(b, g, 4)

    def rt(quat, T):
        R = Rotation.from_quat(quat.reshape(-1, 4)).as_matrix().reshape(b, g, 3, 3)
        out = np.zeros((b, g, 4, 4))
        out[..., :3, :3] = R
        out[..., :3, 3] = -np.einsum("bgij,bgj->bgi", R, T)
        out[..., 3, 3] = 1.0
        return out

    T = rng.uniform([-0.2, -0.2, 0.6], [0.2, 0.2, 1.5], size=(b, g, 3))
    Tp = T + rng.normal(scale=0.03, size=T.shape)
    s = rng.uniform(0.05, 0.3, size=(b, g, 3))
    d = {"valid": rng.random((b, g)) > 0.2, "class_ids": rng.integers(1, 7, (b, g)),
         "symmetric_ids": rng.integers(0, 2, (b, g)),
         "gt_quaternion": q, "pred_quaternion": qp, "gt_T": T, "pred_T": Tp,
         "gt_RT": rt(q, T), "pred_RT": rt(qp, Tp), "gt_scales": s,
         "pred_scales": s * rng.uniform(0.9, 1.1, s.shape)}
    cast = {"valid": bool, "class_ids": np.int32, "symmetric_ids": np.int32}
    d = {k: np.asarray(v, cast.get(k, np.float32)) for k, v in d.items()}
    return {k: jnp.asarray(v) for k, v in d.items()}, {k: torch.from_numpy(v) for k, v in d.items()}


def test_metric_bank_matches_jax():
    rng = np.random.default_rng(7)
    bank_j, bank_t = jm.init_pose_metric_bank(), tm.init_pose_metric_bank()
    for _ in range(2):
        mj, mt = _matched(rng)
        bank_j = jm.update_pose_metric_bank(bank_j, mj)
        bank_t = tm.update_pose_metric_bank(bank_t, mt)
    want = {k: float(v) for k, v in jm.compute_pose_metric_bank(bank_j).items()}
    got = {k: float(v) for k, v in tm.compute_pose_metric_bank(bank_t).items()}
    assert sorted(got) == sorted(want)
    for key in ("degree_error_AP_5", "iou_3d_mAP_0.25", "offset_error_AP_5cm"):
        # The same hits of the same count (the JAX states are float64 under
        # this suite's x64 setting, the port's float32).
        for part in ("correct", "total"):
            assert float(bank_t[key][part]) == float(bank_j[key][part]), (key, part)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    for key in ("degree_error", "degree_error_geodesic", "iou_3d_accuracy", "offset_error"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert 0 < got["degree_error_AP_5"] < 100 and 0 < got["iou_3d_mAP_0.25"]


@pytest.mark.parametrize("with_sample_valid", [False, True])
def test_mask_scores_match_jax(with_sample_valid):
    rng = np.random.default_rng(3)
    gt = rng.integers(0, 4, (3, 16, 20)).astype(np.int32)
    pred = np.where(rng.random(gt.shape) > 0.3, gt, rng.integers(0, 4, gt.shape)).astype(np.int32)
    sv = np.array([1.0, 1.0, 0.0], np.float32) if with_sample_valid else None
    want = jm.mask_scores(jnp.asarray(pred), jnp.asarray(gt), 4,
                          None if sv is None else jnp.asarray(sv))
    got = tm.mask_scores(torch.from_numpy(pred), torch.from_numpy(gt), 4,
                         None if sv is None else torch.from_numpy(sv))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=key)
    assert 0.3 < float(got["dice"]) < 1.0

"""Port parity for `fastposecnn_tpu_torch.losses`: one counterpart for each
test of `tests/test_losses.py`, holding the port's loss and its gradient
against the JAX package's on the same seeded numpy inputs (CPU, float32).

The mask logits and dense fields are NHWC for JAX and NCHW for the port;
gradients are compared in the JAX layout. Tolerance: the repo's golden
atol 2e-4 / rtol 1e-4 (`tests/test_weights.py:137`) on values and
gradients; has-data flags exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu import geometry as JG
from fastposecnn_tpu import losses as JL
from fastposecnn_tpu.data.synthetic import SceneConfig, generate_scene, perfect_logits
from fastposecnn_tpu_torch import losses as TL

ATOL, RTOL = 2e-4, 1e-4
DENSE = {"quaternion": 1.0, "xy": 1.0, "z": 1.0, "scales": 1.0}


def nchw(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def parity(jax_fn, torch_fn, args, wrt, layouts=None):
    """Run `jax_fn(**args)` and `torch_fn(**args)` (each returning a scalar
    loss, or (loss, has)) and compare the values, the has flags and the
    gradients with respect to the args named in `wrt`. `layouts` names the
    args the port takes as NCHW. Returns (the JAX value, the port value)."""
    layouts = layouts or ()

    def split(out):
        return out if isinstance(out, tuple) else (out, None)

    jargs = {k: jnp.asarray(v) for k, v in args.items()}

    def jloss(*diff):
        value, has = split(jax_fn(**{**jargs, **dict(zip(wrt, diff))}))
        return value, has

    if wrt:
        (jv, jhas), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(wrt))),
                                                has_aux=True)(*[jargs[k] for k in wrt])
    else:
        jv, jhas = jloss()
    targs = {}
    for k, v in args.items():
        v = nchw(v) if k in layouts else np.asarray(v)
        t = torch.from_numpy(np.array(v))
        if k in wrt:
            t.requires_grad_(True)
        targs[k] = t
    tv, thas = split(torch_fn(**targs))
    close(tv.detach(), jv, "value")
    if jhas is not None:
        assert float(thas) == float(jhas)
    if wrt:
        tv.backward()
        for k, jg in zip(wrt, jgrads):
            g = targs[k].grad
            g = np.zeros(targs[k].shape, np.float32) if g is None else g.numpy()
            if k in layouts:
                g = g.transpose(0, 2, 3, 1)
            close(g, jg, f"gradient of {k}")
    return float(jv), float(tv.detach())


def matched(g, rng, sym=None, valid=None, keys=("quaternion",)):
    """A seeded matched payload of one image with G slots."""
    q = rng.normal(size=(2, g, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    out = {
        "valid": np.asarray(valid if valid is not None else [True] * g)[None],
        "symmetric_ids": np.asarray(sym if sym is not None else [0] * g, np.int32)[None],
        "gt_quaternion": q[0][None], "pred_quaternion": q[1][None],
    }
    shapes = {"xy": (2,), "z": (), "scales": (3,), "T": (3,)}
    for key in keys:
        if key in shapes:
            lo = 100.0 if key == "z" else -1.0
            for side in ("gt", "pred"):
                out[f"{side}_{key}"] = rng.uniform(lo, lo + 2.0 if key != "z" else 900.0,
                                                   size=(1, g) + shapes[key]).astype(np.float32)
    return out


def matched_fn(jfn_or_tfn, **kw):
    return lambda **m: jfn_or_tfn(m, **kw)


class TestCrossEntropy:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_matches_jax(self, rng, weighted):
        args = {"logits": rng.normal(size=(2, 8, 8, 5)).astype(np.float32),
                "gt": rng.integers(0, 5, size=(2, 8, 8)).astype(np.int32)}
        if weighted:
            args["sw"] = np.asarray([1.0, 0.0], np.float32)
        jv, tv = parity(
            lambda logits, gt, sw=None: JL.cross_entropy(logits, gt, sample_weight=sw),
            lambda logits, gt, sw=None: TL.cross_entropy(logits, gt, sample_weight=sw),
            args, ["logits"], layouts=("logits",))
        ref = torch.nn.CrossEntropyLoss()(torch.from_numpy(nchw(args["logits"][:1 if weighted else 2])),
                                          torch.from_numpy(args["gt"][:1 if weighted else 2]).long())
        np.testing.assert_allclose(tv, float(ref), rtol=1e-5)


class TestFocal:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_matches_jax(self, rng, weighted):
        args = {"logits": rng.normal(size=(2, 4, 4, 3)).astype(np.float32) * 4,
                "gt": rng.integers(0, 3, size=(2, 4, 4)).astype(np.int32)}
        if weighted:
            args["sw"] = np.asarray([0.0, 1.0], np.float32)
        parity(lambda logits, gt, sw=None: JL.focal_loss(logits, gt, sample_weight=sw),
               lambda logits, gt, sw=None: TL.focal_loss(logits, gt, sample_weight=sw),
               args, ["logits"], layouts=("logits",))


class TestQuaternionLoss:
    def test_plain_formula(self):
        m = {"valid": np.asarray([[True, True]]), "symmetric_ids": np.zeros((1, 2), np.int32),
             "gt_quaternion": np.asarray([[[0.0, 0, 0, 1.0], [1.0, 0, 0, 0]]], np.float32),
             "pred_quaternion": np.asarray([[[0.0, 0, 0, 1.0], [0.0, 1, 0, 0]]], np.float32)}
        _, tv = parity(matched_fn(JL.quaternion_loss), matched_fn(TL.quaternion_loss), m,
                       ["pred_quaternion"])
        np.testing.assert_allclose(tv, 0.5 * (np.log(1.1) - np.log(0.1)), rtol=1e-5)

    def test_symmetric_y_rotation_is_free(self, rng):
        base = np.asarray([[0.3, 0.5, -0.2, 0.79]], np.float32)
        base /= np.linalg.norm(base)
        half = np.deg2rad(77.0) / 2
        rot = np.asarray([np.cos(half), 0, np.sin(half), 0], np.float32)
        rotated = np.asarray(JG.quat_multiply_wxyz(jnp.asarray(base[0]), jnp.asarray(rot)))[None]
        values = {}
        for sym in (0, 1):
            m = {"valid": np.asarray([[True]]), "symmetric_ids": np.asarray([[sym]], np.int32),
                 "gt_quaternion": base[None], "pred_quaternion": rotated[None]}
            _, values[sym] = parity(matched_fn(JL.quaternion_loss), matched_fn(TL.quaternion_loss),
                                    m, ["pred_quaternion", "gt_quaternion"])
        assert values[1] < 5e-3 and values[0] > 0.1
        # and on random slots, symmetric and not, with one invalid
        m = matched(5, rng, sym=[1, 0, 1, 0, 1], valid=[True, True, True, False, True])
        parity(matched_fn(JL.quaternion_loss), matched_fn(TL.quaternion_loss), m,
               ["pred_quaternion", "gt_quaternion"])

    def test_empty_matches(self):
        m = {"valid": np.zeros((1, 2), bool), "symmetric_ids": np.zeros((1, 2), np.int32),
             "gt_quaternion": np.zeros((1, 2, 4), np.float32),
             "pred_quaternion": np.zeros((1, 2, 4), np.float32)}
        parity(matched_fn(JL.quaternion_loss), matched_fn(TL.quaternion_loss), m,
               ["pred_quaternion"])
        val, has = TL.quaternion_loss({k: torch.from_numpy(v) for k, v in m.items()})
        assert float(has) == 0.0 and np.isfinite(float(val))


class TestRegressionLosses:
    def test_xy_per_coordinate_sum(self, rng):
        m = {"valid": np.asarray([[True, True]]), "symmetric_ids": np.zeros((1, 2), np.int32),
             "gt_xy": np.asarray([[[10.0, 20.0], [30.0, 40.0]]], np.float32),
             "pred_xy": np.asarray([[[11.0, 18.0], [33.0, 44.0]]], np.float32)}
        _, tv = parity(matched_fn(JL.xy_loss, kind="L1"), matched_fn(TL.xy_loss, kind="L1"),
                       m, ["pred_xy"])
        np.testing.assert_allclose(tv, 5.0, rtol=1e-6)
        for kind in ("L2", "SmoothL1"):
            m = matched(4, rng, valid=[True, False, True, True], keys=("xy",))
            parity(matched_fn(JL.xy_loss, kind=kind), matched_fn(TL.xy_loss, kind=kind),
                   m, ["pred_xy", "gt_xy"])

    def test_z_log_space(self, rng):
        m = {"valid": np.asarray([[True]]), "symmetric_ids": np.zeros((1, 1), np.int32),
             "gt_z": np.asarray([[1000.0]], np.float32),
             "pred_z": np.asarray([[np.e * 1000.0]], np.float32)}
        _, tv = parity(matched_fn(JL.z_loss, kind="L1"), matched_fn(TL.z_loss, kind="L1"),
                       m, ["pred_z"])
        np.testing.assert_allclose(tv, 1.0, rtol=1e-5)
        m = matched(4, rng, valid=[True, True, False, True], keys=("z",))
        m["pred_z"][0, 1] = 0.0  # clamped at 1e-8: no gradient
        for kind in ("L1", "L2", "SmoothL1"):
            parity(matched_fn(JL.z_loss, kind=kind), matched_fn(TL.z_loss, kind=kind),
                   m, ["pred_z"])

    def test_smooth_l1(self, rng):
        m = {"valid": np.asarray([[True]]), "symmetric_ids": np.zeros((1, 1), np.int32),
             "gt_scales": np.zeros((1, 1, 3), np.float32),
             "pred_scales": np.asarray([[[0.5, 2.0, 0.0]]], np.float32)}
        _, tv = parity(matched_fn(JL.scales_loss, kind="SmoothL1"),
                       matched_fn(TL.scales_loss, kind="SmoothL1"), m, ["pred_scales"])
        np.testing.assert_allclose(tv, 0.125 + 1.5, rtol=1e-6)
        m = matched(4, rng, valid=[False, True, True, True], keys=("scales",))
        for kind in ("L1", "L2", "SmoothL1"):
            parity(matched_fn(JL.scales_loss, kind=kind), matched_fn(TL.scales_loss, kind=kind),
                   m, ["pred_scales", "gt_scales"])
        with pytest.raises(NotImplementedError):
            TL.scales_loss({k: torch.from_numpy(v) for k, v in m.items()}, kind="L3")

    def test_rotation_geodesic(self, rng):
        Rz = np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
        m = {"valid": np.asarray([[True]]), "symmetric_ids": np.zeros((1, 1), np.int32),
             "gt_R": np.eye(3, dtype=np.float32)[None, None], "pred_R": Rz[None, None]}
        _, tv = parity(matched_fn(JL.rotation_matrix_loss), matched_fn(TL.rotation_matrix_loss),
                       m, ["pred_R"])
        np.testing.assert_allclose(tv, np.pi / 2, rtol=1e-4)
        # The matrix losses on random poses: R, T, iou3d and offset, with
        # one padded (all-zero) slot, whose norms must stay finite.
        g = 4
        q = rng.normal(size=(2, g, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        R = np.asarray(JG.quat_to_rotmat(jnp.asarray(q, jnp.float32)))
        T = rng.uniform(-0.5, 0.5, size=(2, g, 3)).astype(np.float32)
        T[..., 2] += 1.5
        RT = np.zeros((2, g, 4, 4), np.float32)
        RT[..., :3, :3], RT[..., :3, 3], RT[..., 3, 3] = R, T, 1.0
        m = {"valid": np.asarray([[True, True, True, False]]),
             "symmetric_ids": np.zeros((1, g), np.int32),
             "gt_R": R[0][None], "pred_R": R[1][None], "gt_T": T[0][None], "pred_T": T[1][None],
             "gt_RT": RT[0][None], "pred_RT": RT[1][None],
             "gt_scales": rng.uniform(0.1, 0.3, size=(1, g, 3)).astype(np.float32),
             "pred_scales": rng.uniform(0.1, 0.3, size=(1, g, 3)).astype(np.float32)}
        for key in ("gt_T", "pred_T"):
            m[key][0, 3] = 0.0
        m["gt_RT"][0, 3] = m["pred_RT"][0, 3] = 0.0
        m["pred_RT"][0, 2] = m["gt_RT"][0, 2]  # the same pose: zero offset
        for name, wrt in (("R", ["pred_R"]), ("T", ["pred_T", "gt_T"]),
                          ("iou3d", ["pred_RT", "pred_scales"]), ("offset", ["pred_RT"])):
            parity(matched_fn(JL.MATCHED_LOSSES[name]), matched_fn(TL.MATCHED_LOSSES[name]),
                   m, wrt)


class TestMaskedMSE:
    def test_masks_prediction_outside_fg(self, rng):
        args = {"pred": rng.normal(size=(1, 4, 4, 2)).astype(np.float32),
                "gt": rng.normal(size=(1, 4, 4, 2)).astype(np.float32),
                "cat": np.zeros((1, 4, 4), np.int32)}
        args["cat"][0, :2] = 1
        parity(lambda pred, gt, cat: JL.masked_mse(pred, gt, cat),
               lambda pred, gt, cat: TL.masked_mse(pred, gt, cat), args, ["pred", "gt"])
        args["cat"][:] = 0
        parity(lambda pred, gt, cat: JL.masked_mse(pred, gt, cat),
               lambda pred, gt, cat: TL.masked_mse(pred, gt, cat), args, ["pred"])


def scene_batch(seed=0, loss_targets=False):
    cfg = SceneConfig(height=64, width=64, num_classes=4, max_instances=4)
    scene = generate_scene(np.random.default_rng(seed), cfg)
    logits = perfect_logits(scene, cfg.num_classes, loss_targets=loss_targets)
    gt_mask = scene["mask"][None].astype(np.uint8)
    agg = {k: np.asarray(v)[None] for k, v in scene["agg"].items()}
    return {k: np.asarray(v) for k, v in logits.items()}, gt_mask, agg


FIELDS = ("quaternion", "xy", "z", "scales")


def noisy(logits, seed=1):
    """Head fields moved off their targets by seeded noise: the gradient of
    an L1 term at a perfect fit is the sign of rounding noise."""
    rng = np.random.default_rng(seed)
    return {k: v if k == "mask" else (v + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
            for k, v in logits.items()}


def dense_parity(logits, gt_mask, agg, weights, sample_weight=None, mode="swing",
                 check_grad=True):
    """JAX and port dense supervision on one input; compares the total,
    every logged term and the gradients into the four head fields.
    Returns the port's logs as floats."""
    args = {**{f"f_{k}": logits[k] for k in FIELDS}, "gt_mask": gt_mask,
            **{f"a_{k}": v for k, v in agg.items()}}
    if sample_weight is not None:
        args["sw"] = sample_weight

    def call(fn, to_tensor):
        def run(**a):
            lg = {k: a[f"f_{k}"] for k in FIELDS}
            ag = {k[2:]: v for k, v in a.items() if k.startswith("a_")}
            total, logs = fn(lg, a["gt_mask"], ag, weights, sample_weight=a.get("sw"),
                             sym_quat_mode=mode)
            run.logs = logs
            return total
        return run

    jrun, trun = call(JL.dense_supervision, False), call(TL.dense_supervision, True)
    wrt = [f"f_{k}" for k in FIELDS] if check_grad else []
    parity(jrun, trun, args, wrt, layouts=tuple(f"f_{k}" for k in FIELDS))
    jrun(**{k: jnp.asarray(v) for k, v in args.items()})  # logs outside the trace
    assert set(trun.logs) == set(jrun.logs)
    for key in jrun.logs:
        close(trun.logs[key].detach(), jrun.logs[key], key)
    return {k: float(v.detach()) for k, v in trun.logs.items()}


class TestDenseSupervision:
    def test_perfect_logits_zero_loss(self):
        logits, gt_mask, agg = scene_batch(loss_targets=True)
        # At a perfect fit every L1 term sits at its kink, where the
        # gradient is the sign of rounding noise: values only.
        logs = dense_parity(logits, gt_mask, agg, DENSE, check_grad=False)
        for k in ("quaternion/loss_dense", "xy/loss_dense", "z/loss_dense",
                  "scales/loss_dense", "pose/dense_total"):
            assert logs[k] < 1e-4

    def test_wrong_fields_positive_loss(self):
        logits, gt_mask, agg = scene_batch()
        bad = {k: (v + 1.0 if k != "mask" else v) for k, v in logits.items()}
        assert dense_parity(bad, gt_mask, agg, DENSE)["pose/dense_total"] > 0.5

    def test_zero_weights_trace_nothing(self):
        logits, gt_mask, agg = scene_batch()
        zero = {k: 0.0 for k in DENSE}
        total, logs = TL.dense_supervision(
            {k: torch.from_numpy(nchw(logits[k])) for k in FIELDS},
            torch.from_numpy(gt_mask), {k: torch.from_numpy(v) for k, v in agg.items()}, zero)
        assert float(total) == 0.0 and logs == {}
        dense_parity(noisy(logits), gt_mask, agg, {"xy": 1.0, "z": 0.0})

    def test_sample_weight_gates_everything(self):
        logits, gt_mask, agg = scene_batch()
        logs = dense_parity(noisy(logits), gt_mask, agg, DENSE,
                            sample_weight=np.zeros(1, np.float32))
        assert logs["pose/dense_total"] == 0.0
        dense_parity(noisy(logits), gt_mask, agg, DENSE, sample_weight=np.ones(1, np.float32))

    def test_invalid_instances_excluded(self):
        logits, gt_mask, agg = scene_batch()
        agg["valid"] = np.zeros_like(agg["valid"])
        bad = {k: (v + 3.0 if k != "mask" else v) for k, v in logits.items()}
        assert dense_parity(bad, gt_mask, agg, DENSE)["pose/dense_total"] == 0.0

    def test_dense_quat_target_is_sign_canonical(self):
        logits, gt_mask, agg = scene_batch()
        agg["symmetric_ids"] = np.zeros_like(agg["symmetric_ids"])
        bad = dict(logits, quaternion=logits["quaternion"] + 0.7)
        pos = dense_parity(bad, gt_mask, agg, {"quaternion": 1.0})
        neg = dense_parity(bad, gt_mask, dict(agg, quaternion=-agg["quaternion"]),
                           {"quaternion": 1.0})
        np.testing.assert_allclose(pos["quaternion/loss_dense"], neg["quaternion/loss_dense"],
                                   rtol=1e-6)
        assert pos["quaternion/loss_dense"] > 0.1

    def test_quat_random_is_canonical_hemisphere(self):
        """The port's scene generator draws canonical GT quaternions, as the
        JAX one does, and the port's `quat_canonical` keeps them."""
        from fastposecnn_tpu.data.synthetic import _quat_random as jax_quat_random
        from fastposecnn_tpu_torch import geometry as TG
        from fastposecnn_tpu_torch.data.synthetic import _quat_random

        rng, rng_j = np.random.default_rng(3), np.random.default_rng(3)
        qs = np.stack([_quat_random(rng) for _ in range(64)])
        np.testing.assert_array_equal(qs, np.stack([jax_quat_random(rng_j) for _ in range(64)]))
        assert all(q[np.argmax(np.abs(q))] >= 0 for q in qs)
        np.testing.assert_allclose(np.linalg.norm(qs, axis=-1), 1.0, atol=1e-6)
        q32 = torch.from_numpy(qs.astype(np.float32))
        np.testing.assert_array_equal(TG.quat_canonical(q32).numpy(), q32.numpy())
        np.testing.assert_array_equal(TG.quat_canonical(-q32).numpy(), q32.numpy())

    def test_symmetric_instances_get_dense_swing_supervision(self):
        logits, gt_mask, agg = scene_batch()
        agg["symmetric_ids"] = np.ones_like(agg["symmetric_ids"])
        bad = dict(logits, quaternion=logits["quaternion"] + 3.0)
        assert dense_parity(bad, gt_mask, agg, {"quaternion": 1.0})["quaternion/loss_dense"] > 0.5
        raw = dense_parity(logits, gt_mask, agg, {"quaternion": 1.0})
        assert raw["quaternion/loss_dense"] > 1e-3

    def test_dense_swing_target_sign_invariant(self):
        logits, gt_mask, agg = scene_batch()
        agg["symmetric_ids"] = np.ones_like(agg["symmetric_ids"])
        bad = dict(logits, quaternion=logits["quaternion"] + 0.7)
        pos = dense_parity(bad, gt_mask, agg, {"quaternion": 1.0})
        neg = dense_parity(bad, gt_mask, dict(agg, quaternion=-agg["quaternion"]),
                           {"quaternion": 1.0})
        np.testing.assert_allclose(pos["quaternion/loss_dense"], neg["quaternion/loss_dense"],
                                   rtol=1e-5)

    def test_swing_canonical_is_metric_null(self):
        """The port's swing representative against JAX's, and it scores ~0
        on the port's symmetric degree metrics."""
        import scipy.spatial.transform as sst

        from fastposecnn_tpu_torch import geometry as TG

        q = sst.Rotation.random(128, random_state=7).as_quat().astype(np.float32)
        s = TG.quat_swing_canonical(torch.from_numpy(q))
        close(s, JG.quat_swing_canonical(jnp.asarray(q)))
        ones = torch.ones(q.shape[0])
        assert float(TG.geodesic_quat_distance_deg(torch.from_numpy(q), s, ones).max()) < 0.51
        assert float(TG.quat_distance_deg(torch.from_numpy(q), s, ones).max()) < 0.51
        np.testing.assert_allclose(s[:, 1].numpy(), 0.0, atol=1e-6)

    def test_sym_quat_mode_full_ignores_symmetry_flag(self):
        logits, gt_mask, agg = scene_batch()
        bad = dict(logits, quaternion=logits["quaternion"] + 0.7)
        a = dense_parity(bad, gt_mask, dict(agg, symmetric_ids=np.ones_like(agg["symmetric_ids"])),
                         {"quaternion": 1.0}, mode="full")
        b = dense_parity(bad, gt_mask, dict(agg, symmetric_ids=np.zeros_like(agg["symmetric_ids"])),
                         {"quaternion": 1.0}, mode="full")
        np.testing.assert_allclose(a["quaternion/loss_dense"], b["quaternion/loss_dense"], rtol=1e-6)
        assert a["quaternion/loss_dense"] > 0.1

    def test_sym_quat_mode_full_differs_from_swing_on_symmetric(self):
        logits, gt_mask, agg = scene_batch()
        agg["symmetric_ids"] = np.ones_like(agg["symmetric_ids"])
        q_gt = np.asarray(JG.quat_canonical(jnp.asarray(agg["quaternion"])))
        painted = np.einsum("bnhw,bnd->bhwd", agg["instance_masks"].astype(np.float32), q_gt)
        ncls = logits["quaternion"].shape[-1] // 4
        good = dict(logits, quaternion=np.tile(painted, (1, 1, 1, ncls)).astype(np.float32))
        # The "full" field is a perfect fit (values only, see above).
        lf = dense_parity(good, gt_mask, agg, {"quaternion": 1.0}, mode="full",
                          check_grad=False)
        ls = dense_parity(good, gt_mask, agg, {"quaternion": 1.0}, mode="swing")
        assert lf["quaternion/loss_dense"] < 1e-4 and ls["quaternion/loss_dense"] > 1e-2

    def test_sym_quat_mode_exclude_gates_symmetric_pixels(self):
        logits, gt_mask, agg = scene_batch()
        bad = dict(logits, quaternion=logits["quaternion"] + 3.0)
        sym = dense_parity(bad, gt_mask, dict(agg, symmetric_ids=np.ones_like(agg["symmetric_ids"])),
                           {"quaternion": 1.0}, mode="exclude")
        assert sym["quaternion/loss_dense"] == 0.0
        non = dense_parity(bad, gt_mask, dict(agg, symmetric_ids=np.zeros_like(agg["symmetric_ids"])),
                           {"quaternion": 1.0}, mode="exclude")
        assert non["quaternion/loss_dense"] > 0.5

    def test_sym_quat_mode_invalid_raises(self):
        logits, gt_mask, agg = scene_batch()
        with pytest.raises(NotImplementedError):
            TL.dense_supervision({k: torch.from_numpy(nchw(logits[k])) for k in FIELDS},
                                 torch.from_numpy(gt_mask),
                                 {k: torch.from_numpy(v) for k, v in agg.items()},
                                 {"quaternion": 1.0}, sym_quat_mode="bogus")

"""Port parity for the augmentation (`fastposecnn_tpu_torch/data/augment.py`
and its native operators, `native/augment.cpp`).

- Every operator and compose of the port's numpy path is bit-equal to the
  JAX package's numpy path (`FPCNN_NO_NATIVE_AUGMENT=1`) on the same
  `default_rng` seeds.
- The port's native operators are bit-equal to its numpy ones (the
  counterparts of `tests/test_native.py`'s augment parity tests).
- The behaviour tests of `tests/test_augment.py`, on both of the port's
  paths where the operator has a native one.
- A failed native build raises.
Tolerance: exact everywhere, but where `tests/test_augment.py` states its
own bounds.
"""

import copy

import numpy as np
import pytest

from fastposecnn_tpu.data import augment as JA
from fastposecnn_tpu.data.synthetic import SceneConfig as JSceneConfig
from fastposecnn_tpu.data.synthetic import generate_scene as jgenerate_scene
from fastposecnn_tpu_torch.data import augment as TA
from fastposecnn_tpu_torch.native import augment_lib

SEEDS = (0, 1, 7, 11)


def assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, tuple):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)


def image(seed=0, h=95, w=121):
    """Non-tile-divisible dims exercise CLAHE's edge tiles."""
    return np.random.default_rng(100 + seed).random((h, w, 3)).astype(np.float32)


def scene_sample(seed=5, h=96, w=128, image_dtype=np.uint8):
    scene = jgenerate_scene(np.random.default_rng(seed),
                            JSceneConfig(height=h, width=w, max_instances=4,
                                         render_pose_cues=True))
    img = scene["image"]
    if image_dtype == np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    sample = {"image": img, "mask": (scene["mask"] > 0).astype(np.uint8),
              "depth": np.random.default_rng(seed).random((h, w)).astype(np.float32),
              "agg": scene["agg"]}
    return sample, scene["intrinsics"]


def _homography(A, r, img, **kw):
    return A.sample_homography(*img.shape[:2], r, A.AugmentConfig())


# name -> fn(module, rng, image, **native): every operator and compose.
OPS = {
    "rgb_to_hsv": lambda A, r, img, **kw: A._rgb_to_hsv(np.clip(img, 0, 1)),
    "hsv_to_rgb": lambda A, r, img, **kw: A._hsv_to_rgb(A._rgb_to_hsv(np.clip(img, 0, 1))),
    "additive_gaussian_noise": lambda A, r, img, **kw: A.additive_gaussian_noise(
        img, r, A.AugmentConfig()),
    "clahe": lambda A, r, img, **kw: A.clahe(img, r, A.AugmentConfig(), **kw),
    "random_brightness": lambda A, r, img, **kw: A.random_brightness(img, r, A.AugmentConfig()),
    "random_gamma": lambda A, r, img, **kw: A.random_gamma(img, r, A.AugmentConfig()),
    "box_blur": lambda A, r, img, **kw: A.box_blur(img, **kw),
    "sharpen": lambda A, r, img, **kw: A.sharpen(img, r, A.AugmentConfig(), **kw),
    "motion_blur": lambda A, r, img, **kw: A.motion_blur(img, r, A.AugmentConfig(), **kw),
    "random_contrast": lambda A, r, img, **kw: A.random_contrast(img, r, A.AugmentConfig()),
    "hsv_jitter": lambda A, r, img, **kw: A.hsv_jitter(img, r, A.AugmentConfig(), **kw),
    "sample_homography": _homography,
    "warp_image_bilinear": lambda A, r, img, **kw: A.warp_image(
        img, _homography(A, r, img), order=1, **kw),
    "warp_image_nearest_mask": lambda A, r, img, **kw: A.warp_image(
        (img[..., 0] * 7).astype(np.uint8), _homography(A, r, img), order=0, **kw),
    "warp_image_nearest_depth": lambda A, r, img, **kw: A.warp_image(
        img[..., 1], _homography(A, r, img), order=0, **kw),
    "warp_points": lambda A, r, img, **kw: A.warp_points(
        r.random((10, 2)) * 90, _homography(A, r, img)),
    "apply_photometric": lambda A, r, img, **kw: A.apply_photometric(img, r, **kw),
    "augment_pose_training": lambda A, r, img, **kw: A.augment_pose_training(img, r, **kw),
    "augment_validation": lambda A, r, img, **kw: A.augment_validation(img, r),
    "augment_segmentation": lambda A, r, img, **kw: A.augment_segmentation(
        img, (img[..., 2] > 0.5).astype(np.int32), r, **kw),
}
NATIVE_OPS = ("clahe", "box_blur", "sharpen", "motion_blur", "hsv_jitter",
              "warp_image_bilinear", "warp_image_nearest_mask", "warp_image_nearest_depth",
              "apply_photometric", "augment_pose_training", "augment_segmentation")


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's augmentation on its numpy path."""
    monkeypatch.setenv("FPCNN_NO_NATIVE_AUGMENT", "1")


@pytest.mark.parametrize("name", sorted(OPS))
def test_numpy_operator_matches_jax(name, jax_numpy):
    for seed in SEEDS:
        want = OPS[name](JA, np.random.default_rng(seed), image(seed))
        got = OPS[name](TA, np.random.default_rng(seed), image(seed), native=False)
        assert_tree_equal(got, want, f"{name} seed {seed}")


@pytest.mark.parametrize("image_dtype", [np.uint8, np.float32])
def test_numpy_sample_compose_matches_jax(image_dtype, jax_numpy):
    """`augment_sample` (perspective + photometric, GT through the
    homography) on a scene, over seeds that take and skip the warp."""
    warped = 0
    for seed in range(8):
        sample, K = scene_sample(image_dtype=image_dtype)
        want = JA.augment_sample(copy.deepcopy(sample), np.random.default_rng(seed),
                                 intrinsics=K)
        got = TA.augment_sample(copy.deepcopy(sample), np.random.default_rng(seed),
                                intrinsics=K, native=False)
        assert_tree_equal(got, want, f"seed {seed}")
        warped += not np.array_equal(want["mask"], sample["mask"])
    assert 0 < warped < 8


@pytest.mark.parametrize("name", NATIVE_OPS)
def test_native_operator_matches_numpy(name):
    for seed in SEEDS:
        want = OPS[name](TA, np.random.default_rng(seed), image(seed), native=False)
        got = OPS[name](TA, np.random.default_rng(seed), image(seed), native=True)
        assert_tree_equal(got, want, f"{name} seed {seed}")


def test_native_sample_compose_matches_numpy():
    """The full compose through the native operators, bit-equal to numpy on
    every field, the instance masks and the recomputed GT included."""
    for seed in range(6):
        sample, K = scene_sample(seed=seed)
        want = TA.augment_sample(copy.deepcopy(sample), np.random.default_rng(seed),
                                 intrinsics=K, native=False)
        got = TA.augment_sample(copy.deepcopy(sample), np.random.default_rng(seed),
                                intrinsics=K, native=True)
        assert_tree_equal(got, want, f"seed {seed}")


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the first native call raise: nothing
    falls back to numpy."""
    monkeypatch.setattr(augment_lib, "_lib", None)
    monkeypatch.setattr(augment_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TA.hsv_jitter(image(), np.random.default_rng(0), TA.AugmentConfig(), native=True)


# -- behaviour (counterparts of tests/test_augment.py) -------------------------

BOTH = pytest.mark.parametrize("native", [False, True])


@BOTH
def test_output_range_and_shape(native):
    img = np.random.default_rng(0).random((32, 48, 3)).astype(np.float32)
    out = TA.augment_pose_training(img, np.random.default_rng(0), native=native)
    assert out.shape == img.shape
    assert out.min() >= 0 and out.max() <= 1


@BOTH
def test_deterministic_given_seed(native):
    img = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
    a = TA.augment_pose_training(img, np.random.default_rng(7), native=native)
    b = TA.augment_pose_training(img, np.random.default_rng(7), native=native)
    np.testing.assert_array_equal(a, b)
    c = TA.augment_pose_training(img, np.random.default_rng(8), native=native)
    assert np.abs(a - c).max() > 0


def test_validation_noise_probability():
    """Validation = noise at p=0.2: most draws leave the image untouched."""
    img = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32) * 0.5 + 0.25
    changed = [np.abs(TA.augment_validation(img, np.random.default_rng(s)) - img).max() > 1e-6
               for s in range(200)]
    assert 0.1 < np.mean(changed) < 0.35


@BOTH
def test_segmentation_flip_consistency(native):
    rng = np.random.default_rng(0)
    img = rng.random((16, 16, 3)).astype(np.float32)
    mask = (rng.random((16, 16)) > 0.5).astype(np.int32)
    for seed in range(20):
        _, mask2 = TA.augment_segmentation(img, mask, np.random.default_rng(seed),
                                           native=native)
        if not np.array_equal(mask2, mask):
            assert np.array_equal(mask2, mask[:, ::-1])
            return
    raise AssertionError("no flip in 20 seeds")


@BOTH
def test_clahe_flattens_histogram(native):
    rng = np.random.default_rng(0)
    img = (rng.random((64, 64, 3)) * 0.1 + 0.45).astype(np.float32)
    out = TA.clahe(img, rng, TA.AugmentConfig(), native=native)
    v_in = TA._rgb_to_hsv(img)[..., 2]
    v_out = TA._rgb_to_hsv(np.clip(out, 0, 1))[..., 2]
    assert v_out.std() > 2.0 * v_in.std()


@BOTH
def test_clahe_identity_on_uniform(native):
    img = np.full((32, 32, 3), 0.5, np.float32)
    out = TA.clahe(img, np.random.default_rng(0), TA.AugmentConfig(), native=native)
    assert np.all(np.isfinite(out))
    assert out.std() < 0.05


@BOTH
def test_motion_blur_direction(native):
    """A horizontal kernel smears a vertical line sideways."""
    img = np.zeros((16, 16, 3), np.float32)
    img[:, 8] = 1.0

    class FixedRng:
        def uniform(self, lo, hi):
            return 0.0  # theta = 0: a horizontal kernel

    out = TA.motion_blur(img, FixedRng(), TA.AugmentConfig(), native=native)
    assert out[4, 8, 0] < 1.0
    assert out[4, 7, 0] > 0.0 and out[4, 9, 0] > 0.0


def test_noise_scale_range():
    img = np.full((64, 64, 3), 0.5, np.float32)
    stds = [(TA.additive_gaussian_noise(img, np.random.default_rng(s), TA.AugmentConfig())
             - img).std() for s in range(20)]
    assert 0.005 < min(stds) and max(stds) < 0.06


@BOTH
def test_oneof_structure(native):
    """With only the blur group on (p 1), every draw changes the image."""
    cfg = TA.AugmentConfig(noise_p=0.0, perspective_p=0.0, group1_p=0.0, group2_p=1.0,
                           group3_p=0.0)
    img = (np.random.default_rng(3).random((32, 32, 3)) > 0.5).astype(np.float32)
    for s in range(10):
        out = TA.apply_photometric(img, np.random.default_rng(s), cfg, native=native)
        assert not np.array_equal(out, img)


PERSPECTIVE_ONLY = TA.AugmentConfig(perspective_p=1.0, noise_p=0.0, group1_p=0.0,
                                    group2_p=0.0, group3_p=0.0)


def perspective_sample(h=64, w=64):
    rng = np.random.default_rng(0)
    img = rng.random((h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.uint8)
    mask[20:40, 25:45] = 2
    inst = np.zeros((4, h, w), np.uint8)
    inst[0] = (mask == 2).astype(np.uint8)
    K = np.array([[70.0, 0, w / 2], [0, 70.0, h / 2], [0, 0, 1.0]])
    z = 500.0
    xy = np.array([[35.0, 30.0], [0, 0], [0, 0], [0, 0]], np.float32)
    T = np.linalg.inv(K) @ np.r_[xy[0] * (z / 1000.0), z / 1000.0]
    RT = np.eye(4, dtype=np.float32)
    RT[:3, 3] = -T
    agg = {"instance_masks": inst, "xy": xy, "z": np.array([z, 0, 0, 0], np.float32),
           "T": np.stack([T.astype(np.float32)] + [np.zeros(3, np.float32)] * 3),
           "RT": np.stack([RT] + [np.eye(4, dtype=np.float32)] * 3),
           "valid": np.array([True, False, False, False])}
    return {"image": img, "mask": mask, "depth": np.full((h, w), 500.0, np.float32),
            "agg": agg}, K


@BOTH
def test_gt_warps_with_image(native):
    """The warped GT centre stays inside the warped instance mask, and the
    class mask equals instance 0's support."""
    sample, K = perspective_sample()
    orig = sample["mask"].copy()
    out = TA.augment_sample(sample, np.random.default_rng(5), PERSPECTIVE_ONLY,
                            intrinsics=K, native=native)
    assert not np.array_equal(out["mask"], orig)
    np.testing.assert_array_equal((out["mask"] == 2).astype(np.uint8),
                                  out["agg"]["instance_masks"][0])
    ys, xs = np.nonzero(out["agg"]["instance_masks"][0])
    cx, cy = out["agg"]["xy"][0]
    assert xs.min() - 1 <= cx <= xs.max() + 1
    assert ys.min() - 1 <= cy <= ys.max() + 1


@BOTH
def test_t_rt_consistent_with_warped_xy(native):
    sample, K = perspective_sample()
    agg = TA.augment_sample(sample, np.random.default_rng(5), PERSPECTIVE_ONLY,
                            intrinsics=K, native=native)["agg"]
    proj = K @ agg["T"][0]
    np.testing.assert_allclose(proj[:2] / proj[2], agg["xy"][0], atol=1e-3)
    np.testing.assert_allclose(agg["T"][0][2] * 1000.0, agg["z"][0], atol=1e-2)
    np.testing.assert_allclose(agg["RT"][0][:3, 3], -agg["RT"][0][:3, :3] @ agg["T"][0],
                               atol=1e-5)


@BOTH
def test_invalid_slots_untouched(native):
    sample, K = perspective_sample()
    out = TA.augment_sample(sample, np.random.default_rng(5), PERSPECTIVE_ONLY,
                            intrinsics=K, native=native)
    np.testing.assert_array_equal(out["agg"]["xy"][1:], 0.0)
    np.testing.assert_array_equal(out["agg"]["T"][1:], 0.0)


def test_homography_roundtrip():
    rng = np.random.default_rng(1)
    H = TA.sample_homography(64, 64, rng, TA.AugmentConfig())
    pts = rng.random((10, 2)) * 64
    back = TA.warp_points(TA.warp_points(pts, H), np.linalg.inv(H))
    np.testing.assert_allclose(back, pts, atol=1e-8)


@BOTH
def test_warp_image_identity(native):
    img = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(TA.warp_image(img, np.eye(3), order=1, native=native),
                               img, atol=1e-6)
    m = (img[..., 0] > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(TA.warp_image(m, np.eye(3), order=0, native=native), m)

"""Synthetic NOCS-like scenes with exact ground truth: a copy of the JAX
package's `data/synthetic.py` (numpy and scipy; the same RNG streams, so a
seed gives the same scenes in both packages), plus `to_nchw` for the
port's logits layout.

Two uses:
  1. integration tests: build *perfect* network logits from GT and check the
     whole pipeline (class compress -> CC -> aggregation -> voting -> RT ->
     matching -> losses/metrics) recovers the scene;
  2. benchmarking and the synthetic dataset-on-disk fixture
     (data/nocs_writer.py) when the real NOCS data is unavailable.

GT layout mirrors the reference's per-instance agg_data
(FPC/tools/dataset.py:373-434): class_ids, symmetric_ids, instance_masks,
quaternion (xyzw), scales, xy (x, y pixel center), z (mm), T, R, RT — but
padded to MAX_INSTANCES with a validity mask instead of ragged arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from fastposecnn_tpu_torch import constants


@dataclasses.dataclass
class SceneConfig:
    height: int = 120
    width: int = 160
    num_classes: int = 7  # incl. background
    max_instances: int = 8
    min_instances: int = 1
    max_scene_instances: int = 3
    z_range: tuple = (600.0, 2500.0)
    scale_range: tuple = (0.08, 0.4)
    box_half_extent: tuple = (8, 26)
    dataset: str = "CAMERA"
    # Pose-informative rendering: when True, each instance is a RAY-CAST
    # oriented cuboid whose surface is colored by its normalized
    # object-space coordinates (a NOCS coordinate map, exactly the signal
    # the NOCS dataset itself paints — FPC consumes those as *_coord.png in
    # create_meta+.py). The visible color gradient across the three faces
    # pins the FULL rotation (no shading symmetry: every corner has a
    # unique color), the silhouette size pins scales/z jointly, and a
    # depth-dependent brightness ramp breaks the scale<->z projective
    # degeneracy. Default False keeps the legacy flat render (and its exact
    # RNG stream) that the pipeline-mechanics tests were tuned on.
    # Round-2's weaker Lambert-shaded flat boxes (a ~2-DOF appearance cue
    # for a 3-DOF rotation) plateaued rotation learning at ~50 deg; this
    # renderer exists to make the quaternion pathway demonstrably learnable.
    render_pose_cues: bool = False
    # Stronger orientation cues (round-4 VERDICT weak #6: DEMO_S3
    # plateaued ~24.5 deg despite 10 LR decays; the residual concentrated
    # in symmetric classes' twist + renderer limits). With cue_boost each
    # color channel carries a high-frequency stripe along a DIFFERENT
    # object axis (R<-x, G<-y, B<-z, class-coded frequencies), a unique
    # bright marker paints the (+,+,+) octant corner, and the class-tint
    # blend drops 0.5 -> 0.4 so the NOCS gradient keeps more amplitude.
    # Small rotations then move high-frequency phase, not just the
    # low-frequency NOCS ramp. A/B'd against the base renderer at equal
    # epochs — see BASELINE.md round 5.
    cue_boost: bool = False


def _quat_random(rng) -> np.ndarray:
    q = rng.normal(size=4)
    q = q / np.linalg.norm(q)
    # Canonical hemisphere (largest-|component| positive). Real NOCS GT
    # quats come from deterministic matrix->quat conversion and are
    # sign-consistent; uniform-on-S3 draws are not, which makes any
    # sign-sensitive regression target an unlearnable coin flip (q vs -q
    # render identically). See geometry.quat_canonical.
    pivot = q[np.argmax(np.abs(q))]
    return q if pivot >= 0 else -q


# Well-separated RGB tints for classes 1..6 (bg has none).
_CLASS_TINTS = np.asarray(
    [
        [1.0, 0.1, 0.1],
        [0.1, 1.0, 0.1],
        [0.15, 0.25, 1.0],
        [1.0, 1.0, 0.1],
        [1.0, 0.1, 1.0],
        [0.1, 1.0, 1.0],
    ],
    np.float32,
)


def _raycast_box(R, T_m, half, intr, inv_intr, h, w, stripe_freq=0,
                 tint=None, cue_boost=False):
    """Ray-cast one oriented box; returns (hit [H,W] bool, rgb [H,W,3],
    depth_m [H,W]).

    Camera at the origin looking +z; pixel rays d = inv(K) @ [px, py, 1]
    (z-component 1, so the slab-entry parameter IS camera depth in meters).
    Rays move to object space with p_obj = R @ (p_cam - T) — the same
    camera->object convention as the scene RT below. Surface color is the
    normalized object coordinate p_obj/(2*half) + 0.5, i.e. a NOCS
    coordinate map, optionally modulated by an object-space stripe pattern
    of `stripe_freq` periods along object-x: the CLASS signature. Without
    it every class renders identically, the mask head cannot infer class
    on unseen scenes, and class-aware matching fails on validation —
    silently capping every pose metric (found round 3).
    """
    # Projected-corner bbox bounds the region to cast (cheap numpy).
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float64,
    ) * half
    cam = corners @ R + T_m  # R^T @ c + T, rowwise
    if np.any(cam[:, 2] <= 1e-6):
        return None  # box touches/behind the camera plane
    px = intr[0, 0] * cam[:, 0] / cam[:, 2] + intr[0, 2]
    py = intr[1, 1] * cam[:, 1] / cam[:, 2] + intr[1, 2]
    x0, x1 = int(np.floor(px.min())), int(np.ceil(px.max())) + 1
    y0, y1 = int(np.floor(py.min())), int(np.ceil(py.max())) + 1
    if x0 < 0 or y0 < 0 or x1 > w or y1 > h:
        return None  # keep instances fully in frame (GT stays exact)

    ys, xs = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    d_cam = np.stack([xs, ys, np.ones_like(xs)], -1) @ inv_intr.T
    d = d_cam @ R.T  # R @ d_cam, rowwise
    o = -R @ T_m  # ray origin in object space

    eps = 1e-12
    d_safe = np.where(np.abs(d) < eps, eps, d)
    t1 = (-half - o) / d_safe
    t2 = (half - o) / d_safe
    # Parallel rays hit the slab iff the origin lies inside it.
    inside = (np.abs(o) <= half) | (np.abs(d) >= eps)
    tmin = np.where(np.abs(d) < eps, -np.inf, np.minimum(t1, t2)).max(-1)
    tmax = np.where(np.abs(d) < eps, np.inf, np.maximum(t1, t2)).min(-1)
    hit_r = (tmax >= tmin) & (tmin > 0) & inside.all(-1)

    p_obj = o + tmin[..., None] * d
    rgb_r = np.clip(p_obj / (2 * half) + 0.5, 0.0, 1.0)
    if cue_boost and stripe_freq:
        # Tri-axis per-channel carriers: channel c is striped along object
        # axis c at a class-coded frequency (f, f+3, f+5). Unlike the
        # single-axis stripe below, EVERY rotation DOF modulates some
        # channel's phase at high spatial frequency, so small orientation
        # changes produce large image changes (the twist cue the base
        # renderer lacks). Brightness stays bounded: each channel keeps a
        # 0.55 DC term.
        uvw = np.clip(p_obj / (2 * half) + 0.5, 0.0, 1.0)
        freqs = np.asarray(
            [stripe_freq, stripe_freq + 3, stripe_freq + 5], np.float64)
        rgb_r = rgb_r * (0.55 + 0.45 * np.cos(2 * np.pi * freqs * uvw))
        # Unique bright marker at the (+,+,+) octant corner: an unambiguous
        # orientation landmark visible from most viewpoints.
        corner = (uvw > 0.78).all(-1)
        rgb_r = np.where(corner[..., None], 1.0, rgb_r)
    elif stripe_freq:
        # Multiplicative stripes keep the low-frequency NOCS gradient (the
        # rotation cue) while adding an object-space pattern that doubles
        # as extra pose texture (stripe count varies per class too).
        u = p_obj[..., 0] / (2 * half[0]) + 0.5
        rgb_r = rgb_r * (
            0.75 + 0.25 * np.cos(2 * np.pi * stripe_freq * u)
        )[..., None]
    if tint is not None:
        # Constant class tint BLENDED over the gradient: stripe counts
        # alone proved unlearnable as a class signature on held-out scenes
        # (round-3 diag: 56/68 instances best-overlap-matched with the
        # WRONG class after 225 mask epochs), while a global color is
        # scale/rotation/distance invariant. 60% gradient keeps the
        # orientation cue in every channel.
        w_tint = 0.4 if cue_boost else 0.5
        rgb_r = (1 - w_tint) * rgb_r + w_tint * np.asarray(tint, np.float32)

    hit = np.zeros((h, w), bool)
    rgb = np.zeros((h, w, 3), np.float32)
    depth = np.zeros((h, w), np.float32)
    hit[y0:y1, x0:x1] = hit_r
    rgb[y0:y1, x0:x1] = np.where(hit_r[..., None], rgb_r, 0.0)
    depth[y0:y1, x0:x1] = np.where(hit_r, tmin, 0.0).astype(np.float32)
    return hit, rgb, depth


def _generate_scene_raycast(
    rng: np.random.Generator, cfg: SceneConfig
) -> Dict[str, np.ndarray]:
    """Pose-cue scene: ray-cast NOCS-colored cuboids (see SceneConfig)."""
    import scipy.spatial.transform as _sst

    h, w = cfg.height, cfg.width
    intr = constants.scaled_intrinsics(cfg.dataset, h, w)
    inv_intr = np.linalg.inv(intr)

    g = cfg.max_instances
    mask = np.zeros((h, w), np.int32)
    inst_masks = np.zeros((g, h, w), np.float32)
    class_ids = np.zeros((g,), np.int32)
    sym_ids = np.zeros((g,), np.int32)
    quats = np.zeros((g, 4), np.float32)
    scales = np.zeros((g, 3), np.float32)
    xys = np.zeros((g, 2), np.float32)
    zs = np.zeros((g,), np.float32)
    valid = np.zeros((g,), bool)
    R_all = np.zeros((g, 3, 3), np.float32)
    T_all = np.zeros((g, 3), np.float32)
    RT_all = np.zeros((g, 4, 4), np.float32)

    sym_class_set = set(
        constants.dataset_spec(cfg.dataset).symmetric_class_ids()
    )
    z_near, z_far = cfg.z_range

    image = rng.normal(0.0, 0.03, size=(h, w, 3)).astype(np.float32) + 0.08
    occupied = np.zeros((h, w), bool)
    n_inst = int(rng.integers(cfg.min_instances, cfg.max_scene_instances + 1))
    placed = 0
    for _ in range(n_inst * 6):
        if placed >= n_inst:
            break
        inst_scales = rng.uniform(*cfg.scale_range, 3)
        inst_z = float(rng.uniform(z_near, z_far))
        cx = float(rng.uniform(0.15 * w, 0.85 * w))
        cy = float(rng.uniform(0.15 * h, 0.85 * h))
        q = _quat_random(rng)  # xyzw
        R = _sst.Rotation.from_quat(q).as_matrix()
        cls = int(rng.integers(1, cfg.num_classes))
        z_m = inst_z / 1000.0
        T_m = inv_intr @ np.asarray([cx * z_m, cy * z_m, z_m])
        # Class signature: a distinct constant tint per class (blended over
        # the NOCS gradient) + class-coded stripe count as texture. Without
        # an invariant visual class signature the mask head cannot classify
        # unseen boxes and class-aware matching collapses.
        cast = _raycast_box(R, T_m, inst_scales / 2.0, intr, inv_intr, h, w,
                            stripe_freq=cls + 1,
                            tint=_CLASS_TINTS[(cls - 1) % len(_CLASS_TINTS)],
                            cue_boost=cfg.cue_boost)
        if cast is None:
            continue
        hit, rgb, depth = cast
        if hit.sum() < 12 or (hit & occupied).any():
            continue
        occupied |= hit
        k = placed
        # Depth-dependent brightness ramp: disambiguates the scale<->z
        # projective degeneracy (a bigger box farther away would otherwise
        # render identically).
        shade = 0.35 + 0.65 * np.clip(
            (z_far / 1000.0 - depth) / ((z_far - z_near) / 1000.0), 0.0, 1.0
        )
        image[hit] = (rgb * shade[..., None])[hit]
        mask[hit] = cls
        inst_masks[k][hit] = 1.0
        class_ids[k] = cls
        sym_ids[k] = 1 if cls in sym_class_set else 0
        quats[k] = q
        scales[k] = inst_scales
        xys[k] = (cx, cy)
        zs[k] = inst_z
        R_all[k] = R
        T_all[k] = T_m
        RT_all[k, :3, :3] = R
        RT_all[k, :3, 3] = -R @ T_m
        RT_all[k, 3, 3] = 1.0
        valid[k] = True
        placed += 1

    return {
        "image": image,
        "mask": mask,
        "intrinsics": intr,
        "agg": {
            "class_ids": class_ids,
            "symmetric_ids": sym_ids,
            "instance_masks": inst_masks,
            "quaternion": quats,
            "scales": scales,
            "xy": xys,
            "z": zs,
            "T": T_all,
            "R": R_all,
            "RT": RT_all,
            "valid": valid,
        },
    }


def generate_scene(rng: np.random.Generator, cfg: SceneConfig) -> Dict[str, np.ndarray]:
    """Generate one scene. Returns dense GT + padded instance GT."""
    if cfg.render_pose_cues:
        # Dedicated path (own RNG stream; the legacy flat path below keeps
        # its exact stream so seed-keyed goldens stay stable).
        return _generate_scene_raycast(rng, cfg)
    h, w = cfg.height, cfg.width
    intr = constants.scaled_intrinsics(cfg.dataset, h, w)

    g = cfg.max_instances
    mask = np.zeros((h, w), np.int32)
    inst_masks = np.zeros((g, h, w), np.float32)
    class_ids = np.zeros((g,), np.int32)
    sym_ids = np.zeros((g,), np.int32)
    quats = np.zeros((g, 4), np.float32)
    scales = np.zeros((g, 3), np.float32)
    xys = np.zeros((g, 2), np.float32)
    zs = np.zeros((g,), np.float32)
    valid = np.zeros((g,), bool)

    sym_class_set = set(
        constants.dataset_spec(cfg.dataset).symmetric_class_ids()
    )

    n_inst = int(rng.integers(cfg.min_instances, cfg.max_scene_instances + 1))
    occupied = np.zeros((h, w), bool)
    placed = 0
    fx, fy = intr[0, 0], intr[1, 1]
    for _ in range(n_inst * 4):
        if placed >= n_inst:
            break
        inst_scales = rng.uniform(*cfg.scale_range, 3)
        inst_z = float(rng.uniform(*cfg.z_range))
        hw_half = rng.integers(
            cfg.box_half_extent[0], cfg.box_half_extent[1], 2
        )
        if hw_half[0] + 2 >= h // 2 or hw_half[1] + 2 >= w // 2:
            continue
        cy = int(rng.integers(hw_half[0] + 1, h - hw_half[0] - 1))
        cx = int(rng.integers(hw_half[1] + 1, w - hw_half[1] - 1))
        y0, y1 = cy - hw_half[0], cy + hw_half[0]
        x0, x1 = cx - hw_half[1], cx + hw_half[1]
        region = np.zeros((h, w), bool)
        region[y0:y1, x0:x1] = True
        if (region & occupied).any():
            continue
        occupied |= region
        cls = int(rng.integers(1, cfg.num_classes))
        k = placed
        mask[region] = cls
        inst_masks[k][region] = 1.0
        class_ids[k] = cls
        sym_ids[k] = 1 if cls in sym_class_set else 0
        quats[k] = _quat_random(rng)
        scales[k] = inst_scales
        xys[k] = (cx, cy)
        zs[k] = inst_z
        valid[k] = True
        placed += 1

    # Derive T / R / RT from (quat, xy, z) in host numpy. (This used to call
    # the jnp geometry code eagerly; on a remote-TPU backend every eager op
    # is a ~0.4 s AOT round trip, turning synthetic data generation into
    # seconds per scene. scipy's quaternion->R matches geometry.quat_to_rotmat
    # exactly — tests/test_geometry.py::TestQuatRotmat.)
    import scipy.spatial.transform as _sst

    inv_intr = np.linalg.inv(intr)
    z_m = zs[:, None] / 1000.0
    T = np.concatenate([xys * z_m, z_m], axis=-1) @ inv_intr.T
    q_safe = np.where(valid[:, None], quats, np.asarray([0.0, 0.0, 0.0, 1.0]))
    R = _sst.Rotation.from_quat(q_safe).as_matrix()
    RT = np.zeros((g, 4, 4))
    RT[:, :3, :3] = R
    RT[:, :3, 3] = -np.einsum("kij,kj->ki", R, T)
    RT[:, 3, 3] = 1.0
    R[~valid] = 0
    T[~valid] = 0
    RT[~valid] = 0

    # Simple render: class-colored boxes + noise. With render_pose_cues the
    # fill is Lambert-shaded by the rotated object +z normal (rotation
    # observable) and a second tint channel carries the rotated +x axis.
    image = rng.normal(0.0, 0.05, size=(h, w, 3)).astype(np.float32)
    for k in range(g):
        if valid[k]:
            color = np.asarray(
                [0.2 + 0.1 * class_ids[k], 0.9 - 0.1 * class_ids[k], 0.4]
            )
            if cfg.render_pose_cues:
                n_z = R[k] @ np.asarray([0.0, 0.0, 1.0])
                n_x = R[k] @ np.asarray([1.0, 0.0, 0.0])
                shade = 0.55 + 0.45 * n_z[2]
                color = color * shade + 0.25 * np.asarray(
                    [n_x[0], n_x[1], n_x[2]]
                )
            image[inst_masks[k] > 0] += color

    return {
        "image": image,
        "mask": mask,
        "intrinsics": intr,
        "agg": {
            "class_ids": class_ids,
            "symmetric_ids": sym_ids,
            "instance_masks": inst_masks,
            "quaternion": quats.astype(np.float32),
            "scales": scales.astype(np.float32),
            "xy": xys.astype(np.float32),
            "z": zs.astype(np.float32),  # [G] scalar depth in mm
            "T": T.astype(np.float32),
            "R": R.astype(np.float32),
            "RT": RT.astype(np.float32),
            "valid": valid,
        },
    }


def make_batch(
    rng: np.random.Generator, cfg: SceneConfig, batch_size: int
) -> Dict[str, np.ndarray]:
    """Stack `batch_size` scenes into the training batch layout:
    image [B,H,W,3], mask [B,H,W], agg {k: [B,G,...]}."""
    scenes = [generate_scene(rng, cfg) for _ in range(batch_size)]
    batch = {
        "image": np.stack([s["image"] for s in scenes]),
        # Compact wire dtypes: dense masks ship uint8 and are upcast
        # in-graph (train/task.py upcast_batch) — the f32 GT instance-mask
        # stack alone was 78 MB/step at 480p/batch-4, dominating host->device
        # transfer through slow links.
        "mask": np.stack([s["mask"] for s in scenes]).astype(np.uint8),
        "agg": {
            k: np.stack([s["agg"][k] for s in scenes])
            for k in scenes[0]["agg"]
        },
    }
    batch["agg"]["instance_masks"] = batch["agg"]["instance_masks"].astype(
        np.uint8
    )
    return batch


def perfect_logits(
    scene: Dict[str, np.ndarray], num_classes: int,
    loss_targets: bool = False,
) -> Dict[str, np.ndarray]:
    """Build idealized network outputs from GT (for pipeline tests).

    mask: +-10 logits of the GT class; quaternion/scales/z: GT value painted
    into the GT class's channel group; xy: exact unit vectors toward each
    instance's center.

    loss_targets=True paints the quat field losses.dense_supervision
    actually supervises toward — hemisphere-canonical for non-symmetric
    instances, zero-camera-y-twist swing (geometry.quat_swing_canonical)
    for symmetric ones. The default keeps raw GT quats so pipeline
    recovery tests compare against GT exactly.
    """
    mask = scene["mask"]
    agg = scene["agg"]
    if loss_targets:
        import torch

        from fastposecnn_tpu_torch import geometry

        q = torch.from_numpy(np.asarray(agg["quaternion"], np.float32))
        sym = agg["symmetric_ids"].astype(np.float32)[..., None]
        q_t = (
            geometry.quat_canonical(q).numpy() * (1.0 - sym)
            + geometry.quat_swing_canonical(q).numpy() * sym
        )
        agg = dict(agg)
        agg["quaternion"] = q_t.astype(np.float32)
    h, w = mask.shape
    cm1 = num_classes - 1

    mask_logits = np.full((h, w, num_classes), -10.0, np.float32)
    for c in range(num_classes):
        mask_logits[..., c][mask == c] = 10.0

    quat = np.zeros((h, w, cm1, 4), np.float32)
    xy = np.zeros((h, w, cm1, 2), np.float32)
    z = np.zeros((h, w, cm1), np.float32)
    scales = np.zeros((h, w, cm1, 3), np.float32)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for k in range(agg["valid"].shape[0]):
        if not agg["valid"][k]:
            continue
        m = agg["instance_masks"][k] > 0
        c = int(agg["class_ids"][k]) - 1
        quat[m, c, :] = agg["quaternion"][k]
        scales[m, c, :] = agg["scales"][k]
        z[m, c] = np.log(agg["z"][k])
        dx = agg["xy"][k, 0] - xs
        dy = agg["xy"][k, 1] - ys
        norm = np.sqrt(dx * dx + dy * dy)
        norm[norm == 0] = 1.0
        xy[m, c, 0] = (dx / norm)[m]
        xy[m, c, 1] = (dy / norm)[m]

    # Flatten to the model's class-major flat channel layout
    # (models/pose_regressor.py layout note).
    return {
        "mask": mask_logits[None],
        "quaternion": quat.reshape(h, w, cm1 * 4)[None],
        "xy": xy.reshape(h, w, cm1 * 2)[None],
        "z": z[None],
        "scales": scales.reshape(h, w, cm1 * 3)[None],
    }


def to_nchw(logits: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """NHWC logits (as `perfect_logits` returns them) -> the port's NCHW."""
    return {k: np.ascontiguousarray(v.transpose(0, 3, 1, 2))
            for k, v in logits.items()}

"""Synthetic NOCS-like scenes with exact ground truth, made from a seed.

A copy of the flat renderer of `fastposecnn_tpu_torch/data/synthetic.py`
(`generate_scene` with `render_pose_cues=False`, its RNG stream unchanged):
1 to `max_scene_instances` class-coloured boxes that do not overlap, on
Gaussian noise, with per-instance class, quaternion (xyzw), scales, centre
(x, y), depth z (mm), T, R and RT, padded to `max_instances` slots. The
benchmark keeps its own copy so that a change to the program cannot move
the traffic.

`scene_pool` stacks scenes into the staged trainer's wire layout: the
image as uint8 NHWC (the float render clipped to [0, 1]), the class mask
and the instance masks as uint8, every other field as rendered.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from reference.constants import scaled_intrinsics, symmetric_class_ids


@dataclasses.dataclass
class SceneConfig:
    height: int = 480
    width: int = 640
    num_classes: int = 7  # incl. background
    max_instances: int = 16
    min_instances: int = 1
    max_scene_instances: int = 6
    z_range: tuple = (600.0, 2500.0)
    scale_range: tuple = (0.08, 0.4)
    box_half_extent: tuple = (32, 104)
    dataset: str = "CAMERA"


def _quat_random(rng) -> np.ndarray:
    q = rng.normal(size=4)
    q = q / np.linalg.norm(q)
    pivot = q[np.argmax(np.abs(q))]
    return q if pivot >= 0 else -q


def generate_scene(rng: np.random.Generator, cfg: SceneConfig) -> Dict[str, np.ndarray]:
    """One scene: dense GT (image, mask) and padded instance GT."""
    import scipy.spatial.transform as _sst

    h, w = cfg.height, cfg.width
    intr = scaled_intrinsics(cfg.dataset, h, w)

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
    sym_class_set = set(symmetric_class_ids(cfg.dataset))

    n_inst = int(rng.integers(cfg.min_instances, cfg.max_scene_instances + 1))
    occupied = np.zeros((h, w), bool)
    placed = 0
    for _ in range(n_inst * 4):
        if placed >= n_inst:
            break
        inst_scales = rng.uniform(*cfg.scale_range, 3)
        inst_z = float(rng.uniform(*cfg.z_range))
        hw_half = rng.integers(cfg.box_half_extent[0], cfg.box_half_extent[1], 2)
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

    image = rng.normal(0.0, 0.05, size=(h, w, 3)).astype(np.float32)
    for k in range(g):
        if valid[k]:
            color = np.asarray([0.2 + 0.1 * class_ids[k], 0.9 - 0.1 * class_ids[k], 0.4])
            image[inst_masks[k] > 0] += color

    return {
        "image": image,
        "mask": mask,
        "agg": {
            "class_ids": class_ids,
            "symmetric_ids": sym_ids,
            "instance_masks": inst_masks,
            "quaternion": quats.astype(np.float32),
            "scales": scales.astype(np.float32),
            "xy": xys.astype(np.float32),
            "z": zs.astype(np.float32),
            "T": T.astype(np.float32),
            "R": R.astype(np.float32),
            "RT": RT.astype(np.float32),
            "valid": valid,
        },
    }


def scene_pool(seed: int, cfg: SceneConfig, n: int) -> Dict:
    """`n` scenes from `seed`, stacked in the wire layout (numpy)."""
    rng = np.random.default_rng(seed)
    scenes = [generate_scene(rng, cfg) for _ in range(n)]
    image = np.stack([s["image"] for s in scenes])
    agg = {k: np.stack([s["agg"][k] for s in scenes]) for k in scenes[0]["agg"]}
    agg["instance_masks"] = agg["instance_masks"].astype(np.uint8)
    return {
        "image": np.round(np.clip(image, 0.0, 1.0) * 255.0).astype(np.uint8),
        "mask": np.stack([s["mask"] for s in scenes]).astype(np.uint8),
        "agg": agg,
    }

"""NOCS-format samples: the folder dataset `NOCSDataset` (counterpart of the
JAX package's `data/nocs.py`, :83-332) and `SyntheticNOCSSource`, the same
samples held in memory.

`NOCSDataset` scans a directory tree breadth-first, children sorted, for
`*_color.png` files whose `*_meta+.json` holds an instance of a selected
class (at most `max_size` of them), and reads a sample as the JAX reader
does: the color image as uint8 RGB, the instance-id mask (a 3-channel
CAMERA mask keeps channel 0; 255 is background), the depth (zeros when its
file is missing; 3-channel depth is decoded by `standardize_depth`), the
meta record; distractors and unselected classes are dropped, GT comes from
`extract_instance_gt` at the sample's resolution, and a sample with z <= 0
is rejected as None. Its PNGs are decoded by `data/png.py`, with no image
package. `repoint` moves it to another folder (the staged trainer's bank
rotation).

`SyntheticNOCSSource` yields exactly the samples that
`data/nocs_writer.write_synthetic_nocs` -> `NOCSDataset` yields for the same
seed, without writing or reading a PNG: the image quantized to uint8, the
instance-id mask with 255 as background, the uint16 depth, the meta record
with its float64 RTs, then the same reading steps. The evaluate and
inference CLIs and the smoke use it.

With `augmentation` ('train' or 'valid') a sample ends as the JAX
`NOCSDataset.__getitem__` ends (`data/nocs.py:288-314` there): its draws
come from `default_rng((aug_seed, epoch, i))`, 'train' applies the full
compose (`augment.augment_sample` with the scaled intrinsics), 'valid'
`augment.augment_validation`, and the image is requantized to uint8 with
`rint`. `epoch` is set by `loader.PrefetchLoader` before an epoch's
workers start. `native` picks the host native code (`native/augment.cpp`:
the augmentation's operators, and the folder's PNG unfilter; the default)
or its numpy versions.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from fastposecnn_tpu_torch import constants
from fastposecnn_tpu_torch.data.png import decode_png
from fastposecnn_tpu_torch.data.synthetic import SceneConfig, generate_scene

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def standardize_depth(depth: np.ndarray) -> np.ndarray:
    """16-bit NOCS depth: 3-channel encoded depth becomes high*256+low;
    plain 16-bit passes."""
    if depth.ndim == 3 and depth.shape[2] >= 2:
        return (depth[:, :, 1].astype(np.uint16) * 256
                + depth[:, :, 2].astype(np.uint16)).astype(np.uint16)
    return depth.astype(np.uint16)


def extract_instance_gt(RTs: np.ndarray, intrinsics: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-instance xy/z/R/T from stored RTs: xy = int-quantized projection
    of the object origin; z = inv(RT)[2, 3] * 1000; T = back-projection of
    that quantized origin; R = RT[:3, :3]."""
    n = RTs.shape[0]
    xy = np.zeros((n, 2), np.float32)
    z = np.zeros((n,), np.float32)
    R = np.zeros((n, 3, 3), np.float32)
    T = np.zeros((n, 3), np.float32)
    inv_K = np.linalg.inv(intrinsics)
    for i in range(n):
        inv_RT = np.linalg.inv(RTs[i])
        proj = intrinsics @ inv_RT[:3, 3]
        xy[i] = (proj[:2] / proj[2]).astype(np.int32)
        z[i] = inv_RT[2, 3] * 1000.0
        z_m = z[i] / 1000.0
        T[i] = inv_K @ np.array([xy[i, 0] * z_m, xy[i, 1] * z_m, z_m])
        R[i] = RTs[i][:3, :3]
    return {"xy": xy, "z": z, "R": R, "T": T}


def _scene_record(scene: dict) -> dict:
    """What `write_synthetic_nocs` stores for one scene (its PNGs as arrays,
    its meta record), nocs_writer.py:44-76."""
    agg = scene["agg"]
    valid = agg["valid"]
    n = int(valid.sum())
    color = (np.clip(scene["image"], 0, 1) * 255).astype(np.uint8)
    inst_mask = np.full(scene["mask"].shape, 255, np.uint8)
    depth = np.zeros(scene["mask"].shape, np.uint16)
    for k in range(n):
        inst_mask[agg["instance_masks"][k] > 0] = k + 1
    for k in range(n):
        depth[agg["instance_masks"][k] > 0] = np.uint16(agg["z"][k])
    meta = {
        "instance_dict": {str(k + 1): int(agg["class_ids"][k]) for k in range(n)},
        "scales": agg["scales"][valid],
        "RTs": agg["RT"][valid].astype(np.float64),
        "norm_factors": [1.0] * n,
        "quaternions": agg["quaternion"][valid],
    }
    return {"color": color, "mask": inst_mask, "depth": depth, "meta": meta}


class _NOCSSamples:
    """What both sources share: the class maps and the reading of one scene's
    arrays into a sample (JAX `NOCSDataset.__getitem__`, :227-314)."""

    def __init__(self, dataset_name: str, selected_classes: Optional[Sequence[str]],
                 max_instances: int, augmentation: Optional[str], aug_seed: int,
                 aug_cfg, native: bool):
        if augmentation not in (None, "train", "valid"):
            raise ValueError(f"unknown augmentation mode {augmentation!r}")
        self.augmentation = augmentation
        self.aug_seed = aug_seed
        self.aug_cfg = aug_cfg
        self.native = native
        self.epoch = 0
        self.dataset_name = dataset_name
        self.spec = constants.dataset_spec(dataset_name, selected_classes)
        all_classes = list(constants.CLASSES[dataset_name])
        classes = list(self.spec.classes)
        self.class_values_map = {all_classes.index(c): classes.index(c)
                                 for c in classes}
        self.symmetric_ids = set(self.spec.symmetric_class_ids())
        self.max_instances = max_instances

    def _selected(self, meta: dict) -> bool:
        return any(int(c) in self.class_values_map
                   for c in meta.get("instance_dict", {}).values())

    def _sample(self, i: int, path: str, image: np.ndarray, mask_raw: np.ndarray,
                depth: np.ndarray, meta: dict) -> Optional[Dict[str, np.ndarray]]:
        mask_raw = mask_raw.astype(np.int64)
        mask_raw[mask_raw == 255] = 0  # background

        kept = []  # (instance_id, mapped_class, row index into meta arrays)
        for row, (iid, cls) in enumerate(meta["instance_dict"].items()):
            if int(cls) in self.class_values_map:
                kept.append((int(iid), self.class_values_map[int(cls)], row))

        g = self.max_instances
        h, w = mask_raw.shape
        agg = empty_instances(g, h, w)
        RTs = np.asarray(meta["RTs"], np.float64)
        quats = np.asarray(meta["quaternions"], np.float32)
        scales = np.asarray(meta["scales"], np.float32)
        norm_factors = np.asarray(meta["norm_factors"], np.float32)
        K = constants.scaled_intrinsics(self.dataset_name, h, w)
        derived = extract_instance_gt(RTs, K)

        class_mask = np.zeros((h, w), np.int32)
        for k, (iid, cls, row) in enumerate(kept[:g]):
            region = mask_raw == iid
            class_mask[region] = cls
            agg["class_ids"][k] = cls
            agg["symmetric_ids"][k] = 1 if cls in self.symmetric_ids else 0
            agg["instance_masks"][k] = region
            agg["quaternion"][k] = quats[row]
            agg["scales"][k] = scales[row] / norm_factors[row]
            agg["xy"][k] = derived["xy"][row]
            agg["z"][k] = derived["z"][row]
            agg["T"][k] = derived["T"][row]
            agg["R"][k] = derived["R"][row]
            agg["RT"][k] = RTs[row]
            agg["valid"][k] = True

        if (agg["z"][agg["valid"]] <= 0).any():
            return None
        sample = {
            "path": path,
            "image": image,
            "mask": class_mask.astype(np.uint8),
            "depth": depth.astype(np.float32),
            "agg": agg,
        }
        if self.augmentation:
            sample = self._augment(sample, i, K)
        return sample

    def _augment(self, sample: dict, i: int, K: np.ndarray) -> dict:
        from fastposecnn_tpu_torch.data import augment as A

        rng = np.random.default_rng((self.aug_seed, self.epoch, i))
        if self.augmentation == "train":
            sample = A.augment_sample(sample, rng, self.aug_cfg, intrinsics=K,
                                      native=self.native)
        else:
            img = sample["image"].astype(np.float32) / 255.0
            sample["image"] = A.augment_validation(img, rng, self.aug_cfg)
        sample["image"] = np.clip(np.rint(sample["image"] * 255.0), 0, 255).astype(np.uint8)
        return sample


class SyntheticNOCSSource(_NOCSSamples):
    """`num_samples` synthetic scenes from one `default_rng(seed)` stream,
    read as `NOCSDataset` reads them from disk: scenes without a selected
    class are skipped and at most `max_size` are kept."""

    def __init__(self, num_samples: int, seed: int,
                 scene_cfg: Optional[SceneConfig] = None,
                 dataset_name: str = "CAMERA",
                 selected_classes: Optional[Sequence[str]] = None,
                 max_size: Optional[int] = None, max_instances: int = 16,
                 augmentation: Optional[str] = None, aug_seed: int = 0,
                 aug_cfg=None, native: bool = True):
        super().__init__(dataset_name, selected_classes, max_instances, augmentation,
                         aug_seed, aug_cfg, native)
        cfg = scene_cfg or SceneConfig()
        rng = np.random.default_rng(seed)
        self.records: List[dict] = []
        self.names: List[str] = []
        for i in range(num_samples):
            rec = _scene_record(generate_scene(rng, cfg))
            if self._selected(rec["meta"]):
                self.records.append(rec)
                self.names.append(f"{i // 4:05d}/{i % 4:04d}_color.png")
        if max_size is not None:
            self.records = self.records[:max_size]
            self.names = self.names[:max_size]

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        rec = self.records[i]
        return self._sample(i, self.names[i], rec["color"], rec["mask"],
                            standardize_depth(rec["depth"]), rec["meta"])


class NOCSDataset(_NOCSSamples):
    """A NOCS folder on disk (CAMERA or REAL layout); see the module
    docstring."""

    def __init__(self, dataset_dir, dataset_name: str = "CAMERA",
                 selected_classes: Optional[Sequence[str]] = None,
                 max_size: Optional[int] = None, max_instances: int = 16,
                 augmentation: Optional[str] = None, aug_seed: int = 0,
                 aug_cfg=None, native: bool = True):
        super().__init__(dataset_name, selected_classes, max_instances, augmentation,
                         aug_seed, aug_cfg, native)
        self.max_size = max_size
        self.dataset_dir = pathlib.Path(dataset_dir)
        self.images_fps = self._scan(self.dataset_dir)

    def repoint(self, dataset_dir) -> None:
        """Point the dataset at another folder of the same format and rescan."""
        self.dataset_dir = pathlib.Path(dataset_dir)
        self.images_fps = self._scan(self.dataset_dir)

    def _scan(self, root: pathlib.Path) -> List[pathlib.Path]:
        """Breadth-first, children sorted; stops once `max_size` are found."""
        found: List[pathlib.Path] = []
        queue = [root]
        while queue:
            d = queue.pop(0)
            if not d.exists():
                continue
            for child in sorted(d.iterdir()):
                if child.is_dir():
                    queue.append(child)
                elif child.name.endswith("_color.png") and self._has_instances(child):
                    found.append(child)
            if self.max_size is not None and len(found) >= self.max_size:
                break
        return found[:self.max_size] if self.max_size is not None else found

    @staticmethod
    def _sibling(color_fp, suffix: str) -> pathlib.Path:
        return pathlib.Path(str(color_fp).replace("_color.png", suffix))

    def _has_instances(self, color_fp) -> bool:
        meta_fp = self._sibling(color_fp, "_meta+.json")
        return meta_fp.exists() and self._selected(json.loads(meta_fp.read_text()))

    def __len__(self) -> int:
        return len(self.images_fps)

    def __getitem__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        fp = self.images_fps[i]
        image = decode_png(fp, native=self.native, rgb=True)
        mask_raw = decode_png(self._sibling(fp, "_mask.png"), native=self.native)
        if self.dataset_name == "CAMERA" and mask_raw.ndim == 3:
            mask_raw = mask_raw[:, :, 0]
        depth_fp = self._sibling(fp, "_depth.png")
        depth = (standardize_depth(decode_png(depth_fp, native=self.native))
                 if depth_fp.exists() else np.zeros(mask_raw.shape, np.uint16))
        meta = json.loads(self._sibling(fp, "_meta+.json").read_text())
        return self._sample(i, str(fp), image, mask_raw, depth, meta)


class CAMERADataset(NOCSDataset):
    def __init__(self, dataset_dir, **kw):
        super().__init__(dataset_dir, dataset_name="CAMERA", **kw)


class REALDataset(NOCSDataset):
    def __init__(self, dataset_dir, **kw):
        super().__init__(dataset_dir, dataset_name="REAL", **kw)


def empty_instances(g: int, h: int, w: int) -> Dict[str, np.ndarray]:
    """A sample's `g` GT instance slots, all empty."""
    return {
        "class_ids": np.zeros((g,), np.int32),
        "symmetric_ids": np.zeros((g,), np.int32),
        "instance_masks": np.zeros((g, h, w), np.uint8),
        "quaternion": np.zeros((g, 4), np.float32),
        "scales": np.zeros((g, 3), np.float32),
        "xy": np.zeros((g, 2), np.float32),
        "z": np.zeros((g,), np.float32),
        "T": np.zeros((g, 3), np.float32),
        "R": np.zeros((g, 3, 3), np.float32),
        "RT": np.zeros((g, 4, 4), np.float32),
        "valid": np.zeros((g,), bool),
    }


def collate(samples: Sequence[Optional[dict]]) -> Optional[Dict]:
    """Stack samples; drop Nones; None if every sample was rejected."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    batch = {
        "image": np.stack([s["image"] for s in samples]),
        "mask": np.stack([s["mask"] for s in samples]),
        "agg": {k: np.stack([s["agg"][k] for s in samples])
                for k in samples[0]["agg"]},
    }
    batch["path"] = [s["path"] for s in samples]
    return batch

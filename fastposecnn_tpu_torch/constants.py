"""Dataset constants (a copy of the JAX package's `constants.py:15-82`, without
the matplotlib colormap; the port imports nothing of that package).

CAMERA intrinsics fx=fy=577.5 cx=319.5 cy=239.5; REAL intrinsics
fx=591.0125 fy=590.16775 cx=322.525 cy=244.11084 (public NOCS dataset facts).
"""

from __future__ import annotations

import dataclasses

import numpy as np

CAMERA_CLASSES = ("bg", "bottle", "bowl", "camera", "can", "laptop", "mug")
REAL_CLASSES = CAMERA_CLASSES
# Classes treated as rotationally symmetric about their y axis.
SYMMETRIC_CLASSES = ("bowl", "can", "bottle")

INTRINSICS = {
    "CAMERA": np.array(
        [[577.5, 0.0, 319.5], [0.0, 577.5, 239.5], [0.0, 0.0, 1.0]], dtype=np.float64
    ),
    "REAL": np.array(
        [[591.0125, 0.0, 322.525], [0.0, 590.16775, 244.11084], [0.0, 0.0, 1.0]],
        dtype=np.float64,
    ),
}

CLASSES = {"CAMERA": CAMERA_CLASSES, "REAL": REAL_CLASSES}

IMAGE_HEIGHT = 480
IMAGE_WIDTH = 640


def scaled_intrinsics(dataset_name: str, height: int, width: int) -> np.ndarray:
    """Intrinsics rescaled from the native 640x480 capture to (height, width):
    fx/cx scale with width, fy/cy with height; identity at the native size."""
    K = INTRINSICS[dataset_name].copy()
    K[0] *= width / IMAGE_WIDTH
    K[1] *= height / IMAGE_HEIGHT
    return K


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Static description of one NOCS-style dataset."""

    name: str
    classes: tuple
    symmetric_classes: tuple
    intrinsics: np.ndarray

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def symmetric_class_ids(self) -> tuple:
        return tuple(self.classes.index(c) for c in self.symmetric_classes
                     if c in self.classes)


def dataset_spec(name: str, selected_classes=None) -> DatasetSpec:
    classes = tuple(selected_classes) if selected_classes else CLASSES[name]
    return DatasetSpec(
        name=name,
        classes=classes,
        symmetric_classes=tuple(c for c in SYMMETRIC_CLASSES if c in classes),
        intrinsics=INTRINSICS[name],
    )

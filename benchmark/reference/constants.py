"""Dataset constants of the plain reference: the CAMERA classes and
intrinsics of the NOCS dataset (public facts), ImageNet's normalisation."""

from __future__ import annotations

import numpy as np

CAMERA_CLASSES = ("bg", "bottle", "bowl", "camera", "can", "laptop", "mug")
# Classes treated as rotationally symmetric about their y axis.
SYMMETRIC_CLASSES = ("bowl", "can", "bottle")
INTRINSICS = {
    "CAMERA": np.array([[577.5, 0.0, 319.5], [0.0, 577.5, 239.5], [0.0, 0.0, 1.0]],
                       dtype=np.float64),
}
NATIVE_HEIGHT, NATIVE_WIDTH = 480, 640
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def scaled_intrinsics(dataset: str, height: int, width: int) -> np.ndarray:
    """Intrinsics rescaled from the native 640x480 capture to (height, width)."""
    K = INTRINSICS[dataset].copy()
    K[0] *= width / NATIVE_WIDTH
    K[1] *= height / NATIVE_HEIGHT
    return K


def symmetric_class_ids(dataset: str = "CAMERA") -> tuple:
    return tuple(CAMERA_CLASSES.index(c) for c in SYMMETRIC_CLASSES)

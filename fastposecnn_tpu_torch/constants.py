"""Dataset constants the inference path needs (a copy of the JAX package's
`constants.py:15-48`; the port imports nothing of that package).

CAMERA intrinsics fx=fy=577.5 cx=319.5 cy=239.5; REAL intrinsics
fx=591.0125 fy=590.16775 cx=322.525 cy=244.11084 (public NOCS dataset facts).
"""

from __future__ import annotations

import numpy as np

CAMERA_CLASSES = ("bg", "bottle", "bowl", "camera", "can", "laptop", "mug")

INTRINSICS = {
    "CAMERA": np.array(
        [[577.5, 0.0, 319.5], [0.0, 577.5, 239.5], [0.0, 0.0, 1.0]], dtype=np.float64
    ),
    "REAL": np.array(
        [[591.0125, 0.0, 322.525], [0.0, 590.16775, 244.11084], [0.0, 0.0, 1.0]],
        dtype=np.float64,
    ),
}

IMAGE_HEIGHT = 480
IMAGE_WIDTH = 640


def scaled_intrinsics(dataset_name: str, height: int, width: int) -> np.ndarray:
    """Intrinsics rescaled from the native 640x480 capture to (height, width):
    fx/cx scale with width, fy/cy with height; identity at the native size."""
    K = INTRINSICS[dataset_name].copy()
    K[0] *= width / IMAGE_WIDTH
    K[1] *= height / IMAGE_HEIGHT
    return K

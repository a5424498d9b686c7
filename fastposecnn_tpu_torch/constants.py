"""Dataset constants (a copy of the JAX package's `constants.py`; the port
imports nothing of that package). `colormap` builds matplotlib's "hsv"
colormap from its segment data with numpy alone, so class colours need no
matplotlib.

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


# matplotlib's "hsv" colormap (`matplotlib._cm._hsv_data`): (x, y0, y1) rows
# of each channel's piecewise-linear map of [0, 1], sampled into a 256-entry
# table as `matplotlib.colors.LinearSegmentedColormap` does.
_HSV_SEGMENTS = {
    "red": ((0.0, 1.0, 1.0), (0.15873, 1.0, 1.0), (0.174603, 0.96875, 0.96875),
            (0.333333, 0.03125, 0.03125), (0.349206, 0.0, 0.0), (0.666667, 0.0, 0.0),
            (0.68254, 0.03125, 0.03125), (0.84127, 0.96875, 0.96875),
            (0.857143, 1.0, 1.0), (1.0, 1.0, 1.0)),
    "green": ((0.0, 0.0, 0.0), (0.15873, 0.9375, 0.9375), (0.174603, 1.0, 1.0),
              (0.507937, 1.0, 1.0), (0.666667, 0.0625, 0.0625), (0.68254, 0.0, 0.0),
              (1.0, 0.0, 0.0)),
    "blue": ((0.0, 0.0, 0.0), (0.333333, 0.0, 0.0), (0.349206, 0.0625, 0.0625),
             (0.507937, 1.0, 1.0), (0.84127, 1.0, 1.0), (0.857143, 0.9375, 0.9375),
             (1.0, 0.09375, 0.09375)),
}
_LUT_SIZE = 256


def _lookup_table(segments, n: int = _LUT_SIZE) -> np.ndarray:
    """matplotlib's `colors._create_lookup_table(n, segments)` at gamma 1."""
    data = np.asarray(segments, np.float64)
    x, y0, y1 = data[:, 0] * (n - 1), data[:, 1], data[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def colormap(num_classes: int, bg_index: int = 0) -> np.ndarray:
    """[num_classes, 3] float64 class colours: the "hsv" colormap at
    x / num_classes, black for the background (FPC/tools/project.py:52-66);
    equal to the JAX package's, which asks matplotlib."""
    lut = np.stack([_lookup_table(_HSV_SEGMENTS[c]) for c in ("red", "green", "blue")], -1)
    out = np.zeros((num_classes, 3))
    for x in range(num_classes):
        if x != bg_index:
            i = np.array(x / num_classes) * _LUT_SIZE
            out[x] = lut[min(int(i), _LUT_SIZE - 1)]
    return out

"""cv2 drawing of poses on images: 3D boxes, axes and text tags
(counterpart of the JAX package's `utils/draw.py`; the reference's
FPC/tools/draw.py: draw_3d_bbox:198-222, draw_axes:224-252,
draw_text:254-292, draw_RT:141-179, draw_detections:33-81).

Host numpy in float64; points are projected with the port's host geometry
(`eval_host._camera_to_world`, `geometry.get_3d_bbox`). cv2 is imported by
each function that draws: without it they raise an ImportError that names
the package (`utils.optional.need`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from fastposecnn_tpu_torch import eval_host, geometry
from fastposecnn_tpu_torch.utils.optional import need

# corner pairs of `geometry.get_3d_bbox`'s order
_BOX_EDGES = ((0, 1), (0, 2), (1, 3), (2, 3),  # +y face
              (4, 5), (4, 6), (5, 7), (6, 7),  # -y face
              (0, 4), (1, 5), (2, 6), (3, 7))  # verticals


def _cv2():
    return need("cv2", "drawing poses (utils/draw.py)")


def project_pts(pts3d: np.ndarray, RT: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """Object-frame points [3, N] -> int32 pixels [N, 2], through inv(RT)
    and K, in float64."""
    cam = eval_host._camera_to_world(np.asarray(pts3d, np.float64),
                                     np.asarray(RT, np.float64))
    proj = np.einsum("ij,...jn->...in", np.asarray(intrinsics, np.float64), cam)
    px = proj[..., :2, :] / proj[..., 2:3, :]
    return px.T.astype(np.int32)


def draw_3d_bbox(image: np.ndarray, RT: np.ndarray, scales: np.ndarray,
                 intrinsics: np.ndarray, color=(255, 0, 0), thickness: int = 2) -> np.ndarray:
    """The projected wireframe box of `scales` (float32 corners, as the JAX
    package computes them)."""
    cv2 = _cv2()
    corners = geometry.get_3d_bbox(torch.as_tensor(np.asarray(scales), dtype=torch.float32))
    px = project_pts(corners.numpy(), RT, intrinsics)
    img = image.copy()
    for a, b in _BOX_EDGES:
        cv2.line(img, tuple(px[a]), tuple(px[b]), color, thickness)
    return img


def draw_axes(image: np.ndarray, RT: np.ndarray, intrinsics: np.ndarray,
              scale: float = 0.3, thickness: int = 2) -> np.ndarray:
    """Origin and xyz axes: x red, y green, z blue."""
    cv2 = _cv2()
    axes = scale * np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64).T
    px = project_pts(axes, RT, intrinsics)
    img = image.copy()
    for i, color in ((1, (0, 0, 255)), (2, (0, 255, 0)), (3, (255, 0, 0))):
        cv2.line(img, tuple(px[0]), tuple(px[i]), color, thickness)
    return img


def draw_text(image: np.ndarray, text: str, org, color=(255, 255, 255), bg=True) -> np.ndarray:
    """`text` at `org` (its baseline's left end), on a black box if `bg`."""
    cv2 = _cv2()
    img = image.copy()
    font, fs, th = cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1
    if bg:
        (tw, tht), _ = cv2.getTextSize(text, font, fs, th)
        cv2.rectangle(img, (org[0] - 2, org[1] - tht - 2), (org[0] + tw + 2, org[1] + 2),
                      (0, 0, 0), -1)
    cv2.putText(img, text, org, font, fs, color, th, cv2.LINE_AA)
    return img


def draw_RT(image: np.ndarray, RT: np.ndarray, scales: np.ndarray, intrinsics: np.ndarray,
            color=(255, 0, 0), tag: Optional[str] = None) -> np.ndarray:
    """Box, axes and an optional tag above the projected origin."""
    img = draw_3d_bbox(image, RT, scales, intrinsics, color=color)
    img = draw_axes(img, RT, intrinsics)
    if tag:
        origin = project_pts(np.zeros((3, 1)), RT, intrinsics)[0]
        img = draw_text(img, tag, (int(origin[0]), int(origin[1]) - 6))
    return img


def draw_instances(image: np.ndarray, RTs: Sequence[np.ndarray], scales: Sequence[np.ndarray],
                   class_names: Sequence[str], intrinsics: np.ndarray,
                   valid: Optional[Sequence[bool]] = None, color=(255, 0, 0)) -> np.ndarray:
    """Every (valid) instance of one image, tagged with its class name."""
    _cv2()
    img = image.copy()
    for i in range(len(RTs)):
        if valid is not None and not valid[i]:
            continue
        img = draw_RT(img, RTs[i], scales[i], intrinsics, color=color,
                      tag=class_names[i] if class_names else None)
    return img

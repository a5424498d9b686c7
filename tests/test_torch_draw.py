"""The port's pose drawing (`utils/draw.py`) against the JAX package's, on
the same poses and the same cv2: every function gives exactly the same
pixels. The scales are float32, so that both packages compute the box
corners in float32 (as the JAX package does without x64, which these
tests turn on). Without cv2 each drawing function raises and names it."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.spatial.transform as sst

from fastposecnn_tpu.utils import draw as J
from fastposecnn_tpu_torch.utils import draw as T

K = np.asarray([[120.0, 0, 64.5], [0, 118.0, 47.5], [0, 0, 1]])
REPO = pathlib.Path(__file__).resolve().parents[1]


def poses(n=3, seed=0):
    """n object poses (world -> camera RTs) in front of the camera, and
    float32 scales."""
    rng = np.random.default_rng(seed)
    RTs = []
    for _ in range(n):
        inv = np.eye(4)
        inv[:3, :3] = sst.Rotation.from_euler("xyz", rng.uniform(-60, 60, 3),
                                              degrees=True).as_matrix()
        inv[:3, 3] = (rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15), rng.uniform(0.8, 1.5))
        RTs.append(np.linalg.inv(inv))
    return np.stack(RTs), rng.uniform(0.1, 0.4, (n, 3)).astype(np.float32)


def image(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (96, 128, 3), dtype=np.uint8)


def test_project_pts_matches_jax():
    RTs, scales = poses()
    pts = np.random.default_rng(2).normal(size=(3, 20)) * 0.2
    for RT in RTs:
        got = T.project_pts(pts, RT, K)
        assert got.dtype == np.int32 and got.shape == (20, 2)
        np.testing.assert_array_equal(got, J.project_pts(pts, RT, K))


@pytest.mark.parametrize("seed", [0, 1])
def test_draw_functions_give_jax_pixels(seed):
    RTs, scales = poses(seed=seed)
    img = image(seed)
    for i in range(len(RTs)):
        args = (img, RTs[i], scales[i], K)
        np.testing.assert_array_equal(T.draw_3d_bbox(*args, color=(0, 255, 0), thickness=1),
                                      J.draw_3d_bbox(*args, color=(0, 255, 0), thickness=1))
        np.testing.assert_array_equal(T.draw_axes(img, RTs[i], K, scale=0.2),
                                      J.draw_axes(img, RTs[i], K, scale=0.2))
        np.testing.assert_array_equal(T.draw_RT(*args, tag="mug"), J.draw_RT(*args, tag="mug"))
    np.testing.assert_array_equal(T.draw_text(img, "bowl 0.93", (20, 30)),
                                  J.draw_text(img, "bowl 0.93", (20, 30)))
    np.testing.assert_array_equal(T.draw_text(img, "x", (5, 90), bg=False),
                                  J.draw_text(img, "x", (5, 90), bg=False))
    valid = [True, False, True]
    got = T.draw_instances(img, RTs, scales, ["bottle", "bowl", "mug"], K, valid=valid)
    assert not np.array_equal(got, img)
    np.testing.assert_array_equal(
        got, J.draw_instances(img, RTs, scales, ["bottle", "bowl", "mug"], K, valid=valid))


_NO_CV2 = """
import sys
sys.modules["cv2"] = None
import numpy as np
from fastposecnn_tpu_torch.utils import draw
img, RT, K = np.zeros((8, 8, 3), np.uint8), np.eye(4), np.eye(3)
assert draw.project_pts(np.ones((3, 1)), RT, K).shape == (1, 2)  # numpy alone
for fn in (lambda: draw.draw_3d_bbox(img, RT, np.ones(3), K), lambda: draw.draw_axes(img, RT, K),
           lambda: draw.draw_text(img, "a", (1, 1)), lambda: draw.draw_RT(img, RT, np.ones(3), K),
           lambda: draw.draw_instances(img, [RT], [np.ones(3)], ["a"], K)):
    try:
        fn()
    except ImportError as e:
        assert "opencv-python (cv2)" in str(e), e
    else:
        raise AssertionError("drew without cv2")
print("ok")
"""


def test_drawing_without_cv2_names_it():
    proc = subprocess.run([sys.executable, "-c", _NO_CV2], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]

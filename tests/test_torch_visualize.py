"""The port's figures and tables (`utils/visualize.py`, `utils/report.py`,
`constants.colormap`) against the JAX package's: counterparts of
`tests/test_loader_viz.py:59-176`. Colourised arrays are exactly equal to
JAX's; figures are checked for shape; `save_aps` writes the CSV text JAX
writes (this machine has pandas but no Excel engine, so both write CSV,
and the port's numpy writer gives the same text). With cv2, matplotlib or
pandas blocked (in a subprocess), each entry point that needs one raises
and names it, while the numpy-only colourisers and the CSV table work."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from fastposecnn_tpu import constants as jconst
from fastposecnn_tpu.utils import report as jreport
from fastposecnn_tpu.utils import visualize as J
from fastposecnn_tpu_torch import constants
from fastposecnn_tpu_torch.utils import report
from fastposecnn_tpu_torch.utils import visualize as T

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def plt():
    import matplotlib.pyplot as plt

    yield plt
    plt.close("all")


@pytest.mark.parametrize("num_classes", [2, 3, 7, 13])
def test_colormap_equals_matplotlibs(num_classes):
    np.testing.assert_array_equal(constants.colormap(num_classes),
                                  jconst.colormap(num_classes))
    np.testing.assert_array_equal(constants.colormap(num_classes, bg_index=2),
                                  jconst.colormap(num_classes, bg_index=2))


def test_figures_build(rng, plt):
    img = rng.random((32, 32, 3)).astype(np.float32)
    mask = rng.integers(0, 4, (32, 32))
    dense = rng.random((32, 32))
    np.testing.assert_array_equal(T.colorize_mask(mask, 4), J.colorize_mask(mask, 4))
    for data in (dense, rng.random((32, 32, 2)), rng.random((32, 32, 3))):
        np.testing.assert_array_equal(T.colorize_dense(data), J.colorize_dense(data))
    fig = T.make_summary_figure(rgb=img, mask=T.colorize_mask(mask, 4), z=T.colorize_dense(dense))
    arr = T.figure_to_array(fig)
    assert arr.dtype == np.uint8 and arr.shape == (400, 1200, 3)
    np.testing.assert_array_equal(T.denormalize_image(img), J.denormalize_image(img))
    wire = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(T.denormalize_image(wire), J.denormalize_image(wire))


def test_hough_and_pose_overlays(rng):
    img = rng.random((32, 32, 3)).astype(np.float32)
    centers = np.asarray([[10.0, 12.0], [20.0, 8.0]])
    valid = np.asarray([True, False])
    got = T.visualize_hypothesis(img, centers, valid, gt_centers=centers + 1)
    assert got.shape == img.shape
    np.testing.assert_array_equal(got, J.visualize_hypothesis(img, centers, valid,
                                                              gt_centers=centers + 1))
    K = np.asarray([[60.0, 0, 16], [0, 60, 16], [0, 0, 1]])
    RT = np.eye(4)
    RT[2, 3] = -1.0
    pred = RT.copy()
    pred[:3, 3] = (0.05, 0.02, -1.1)
    args = (img, RT[None], np.ones((1, 3), np.float32) * 0.3, pred[None],
            np.ones((1, 3), np.float32) * 0.25, np.asarray([True]), K)
    got = T.compare_pose_performance(*args)
    assert got.shape == img.shape
    np.testing.assert_array_equal(got, J.compare_pose_performance(*args))


def test_ap_plot_and_report(tmp_path, plt):
    thr = {"3d_iou": np.linspace(0, 1, 5), "degree_error+offset_error": np.asarray([5.5, 10.5,
                                                                                   10.10])}
    aps = {"3d_iou": {"bottle": np.linspace(1, 0, 5) / 3, "mean": np.linspace(1, 0, 5)},
           "degree_error+offset_error": {"bottle": np.asarray([0.1, np.nan, 1 / 3]),
                                         "bowl": np.zeros(3), "mean": np.ones(3)}}
    fig = T.plot_aps(aps, thr, {"3d_iou": "IoU"}, {"3d_iou": "x"}, ["bottle", "mean"])
    assert len(fig.axes) == 2
    fig.savefig(tmp_path / "aps.png")
    assert (tmp_path / "aps.png").stat().st_size > 0
    names = ["bottle", "mean"]
    got = report.save_aps(tmp_path / "t.xlsx", thr, aps, names)
    want = jreport.save_aps(tmp_path / "j.xlsx", thr, aps, names)
    assert got == tmp_path / "t" and want == tmp_path / "j"  # no Excel engine here
    for metric in thr:
        text = (want / f"{metric}.csv").read_text()
        assert (got / f"{metric}.csv").read_text() == text
        report._write_csv(tmp_path / "numpy.csv", thr[metric],
                          report._columns(aps[metric], names))
        assert (tmp_path / "numpy.csv").read_text() == text
    frames, jframes = report.aps_to_frames(thr, aps, names), jreport.aps_to_frames(thr, aps, names)
    for metric in thr:
        assert frames[metric].equals(jframes[metric])


def test_dense_colorizers(rng):
    h, w = 24, 32
    quat = rng.normal(size=(h, w, 4)).astype(np.float32)
    quat[:5] = 0  # background rows
    out = T.colorize_quaternion(quat)
    assert out.shape == (h, w, 3)
    np.testing.assert_array_equal(out, J.colorize_quaternion(quat))
    np.testing.assert_array_equal(out[:5], 0.0)
    np.testing.assert_array_equal(T.colorize_quaternion(quat, bg="white"),
                                  J.colorize_quaternion(quat, bg="white"))
    z, scales, xy = rng.random((h, w)) * 1.4 - 0.2, rng.random((h, w, 3)), rng.random((h, w, 2))
    np.testing.assert_array_equal(T.colorize_z(z), J.colorize_z(z))
    np.testing.assert_array_equal(T.colorize_z(z, cmap="magma"), J.colorize_z(z, cmap="magma"))
    np.testing.assert_array_equal(T.colorize_scales(scales), J.colorize_scales(scales))
    np.testing.assert_array_equal(T.colorize_xy(xy), J.colorize_xy(xy))
    mask = (rng.random((h, w)) > 0.5).astype(np.int32)
    field = rng.normal(size=(h, w, 2))
    ang = T.colorize_xy_angle(mask, field)
    np.testing.assert_array_equal(ang, J.colorize_xy_angle(mask, field))
    np.testing.assert_array_equal(ang[mask == 0], 0.0)


def test_hough_voting_overlay(rng):
    mask = np.zeros((32, 32), np.float32)
    mask[8:20, 8:20] = 1.0
    hyp = rng.uniform(0, 32, size=(16, 2))
    hyp[0] = (-40, 90)  # out of frame: clamped, visible
    img = T.visualize_hough_voting(mask, hyp, hyp[:8], np.r_[14.0, 14.0])
    np.testing.assert_array_equal(img, J.visualize_hough_voting(mask, hyp, hyp[:8],
                                                                np.r_[14.0, 14.0]))
    np.testing.assert_array_equal(img[14, 14], (1.0, 0.0, 0.0))
    assert (img[..., 2] == 1).any()


def test_quaternion_quiver_and_qv_mult(plt):
    q = np.asarray([0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)])  # 90 deg about z
    np.testing.assert_allclose(T.qv_mult(q, np.asarray([1.0, 0.0, 0.0])), [0.0, 1.0, 0.0],
                               atol=1e-12)
    qs = np.random.default_rng(3).normal(size=(5, 4))
    np.testing.assert_array_equal(T.qv_mult(qs, np.eye(3)[1]), J.qv_mult(qs, np.eye(3)[1]))
    fig = T.plot_quaternions(np.stack([q, q]), name="q")
    assert len(fig.axes) == 1 and fig._suptitle.get_text() == "q"


def test_compare_all_performance_grid(rng, plt):
    h, w, n = 24, 32, 3
    cat = {
        "mask": rng.integers(0, 3, size=(h, w)),
        "z": rng.random((h, w)).astype(np.float32),
        "scales": rng.random((h, w, 3)).astype(np.float32),
        "quaternion": rng.normal(size=(h, w, 4)).astype(np.float32),
        "xy": rng.normal(size=(h, w, 2)).astype(np.float32),
    }
    agg = {"valid": np.asarray([False, True, False]),
           "hypothesis": rng.uniform(0, 30, size=(n, 8, 2)),
           "pruned_hypothesis": rng.uniform(0, 30, size=(n, 8, 2)),
           "xy": rng.uniform(0, 30, size=(n, 2))}
    RT = np.eye(4)
    RT[2, 3] = -1.0
    matched = {"gt_RT": RT[None], "gt_scales": np.full((1, 3), .3, np.float32),
               "pred_RT": RT[None], "pred_scales": np.full((1, 3), .2, np.float32),
               "valid": np.asarray([True])}
    K = np.asarray([[60.0, 0, 16], [0, 60, 12], [0, 0, 1]])
    image = rng.random((h, w, 3))
    figs = T.compare_all_performance(image, cat, num_classes=3, gt_mask=cat["mask"],
                                     aggregated=agg, matched=matched, intrinsics=K)
    assert [len(f.axes) for f in figs] == [2, 6, 1]
    jfigs = J.compare_all_performance(image, cat, num_classes=3, gt_mask=cat["mask"],
                                      aggregated=agg, matched=matched, intrinsics=K)
    for f, g in zip(figs, jfigs):
        for a, b in zip(f.axes, g.axes):
            assert a.get_title() == b.get_title()
            np.testing.assert_array_equal(a.images[0].get_array(), b.images[0].get_array())


_BLOCKED = """
import sys
sys.modules[{module!r}] = None
import numpy as np
from fastposecnn_tpu_torch.utils import report, visualize as vz
rng = np.random.default_rng(0)
# numpy alone: these work whatever is missing
vz.colorize_mask(rng.integers(0, 3, (4, 4)), 3)
vz.colorize_quaternion(rng.normal(size=(4, 4, 4)))
vz.colorize_scales(rng.random((4, 4, 3)))
vz.colorize_xy(rng.random((4, 4, 2)))
vz.visualize_hough_voting(np.ones((16, 16)), rng.random((3, 2)) * 16, rng.random((2, 2)) * 16,
                          np.r_[8.0, 8.0])
thr = {{"m": np.linspace(0, 1, 3)}}
aps = {{"m": {{"mean": np.asarray([1.0, 0.5, 0.0])}}}}
out = report.save_aps({tmp!r} + "/t.xlsx", thr, aps, ["mean"])
assert (out / "m.csv").read_text() == ",mean\\n0.0,100.0\\n0.5,50.0\\n1.0,0.0\\n"
img, RT, K = np.zeros((16, 16, 3)), np.eye(4), np.eye(3)
calls = {{
    "matplotlib": [lambda: vz.colorize_dense(np.ones((4, 4))), lambda: vz.colorize_z(np.ones((4, 4))),
                   lambda: vz.colorize_xy_angle(np.ones((4, 4)), np.ones((4, 4, 2))),
                   lambda: vz.make_summary_figure(a=img), lambda: vz.plot_quaternions(np.eye(4)[3]),
                   lambda: vz.plot_aps(aps, thr, {{}}, {{}}, ["mean"]),
                   lambda: vz.compare_all_performance(img, {{}}, 3),
                   lambda: vz.figure_to_array(None)],
    "cv2": [lambda: vz.visualize_hypothesis(img, np.zeros((1, 2)), [True]),
            lambda: vz.compare_pose_performance(img, RT[None], np.ones((1, 3)), RT[None],
                                                np.ones((1, 3)), [True], K)],
    "pandas": [lambda: report.aps_to_frames(thr, aps, ["mean"])],
}}[{module!r}]
for fn in calls:
    try:
        fn()
    except ImportError as e:
        assert {name!r} in str(e), e
    else:
        raise AssertionError("ran without " + {module!r})
print("ok", len(calls))
"""


@pytest.mark.parametrize("module,name,calls", [("matplotlib", "matplotlib", 8),
                                               ("cv2", "opencv-python (cv2)", 2),
                                               ("pandas", "pandas", 1)])
def test_missing_package_is_named(tmp_path, module, name, calls):
    code = _BLOCKED.format(module=module, name=name, tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["ok", str(calls)]

"""Figures: colourised dense maps, the Hough-voting overlay, summary grids,
GT-against-prediction poses and AP curves (counterpart of the JAX package's
`utils/visualize.py`; the reference's FPC/tools/visualize.py families:
colourised maps :50-292, hough voting :296-399, the summary grid :404-458,
compare_pose_performance_v5 :985-1040, plot_aps :1231-1267).

Arrays are host numpy in the JAX package's layout (images [H, W, 3], fields
[H, W, C]). matplotlib is imported only by what draws with it: the
colormaps of `colorize_dense` (one channel), `colorize_z` and
`colorize_xy_angle`, the figures and `figure_to_array`; cv2 by
`visualize_hypothesis` and the pose drawing. Without the package they raise
an ImportError that names it (`utils.optional`). `colorize_mask` (the
port's own `constants.colormap`), `colorize_quaternion`,
`colorize_scales`, `colorize_xy`, `visualize_hough_voting` and `qv_mult`
need numpy alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from fastposecnn_tpu_torch.constants import colormap
from fastposecnn_tpu_torch.utils import draw
from fastposecnn_tpu_torch.utils.optional import need, pyplot


def denormalize_image(image: np.ndarray) -> np.ndarray:
    """An image to [0, 1] for display: ImageNet normalization undone for a
    float image; a uint8 wire image rescaled."""
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    from fastposecnn_tpu_torch.data.nocs import IMAGENET_MEAN, IMAGENET_STD

    return np.clip(image * IMAGENET_STD + IMAGENET_MEAN, 0, 1)


def colorize_mask(mask: np.ndarray, num_classes: int) -> np.ndarray:
    return colormap(num_classes)[np.clip(mask, 0, num_classes - 1)]


def colorize_dense(data: np.ndarray) -> np.ndarray:
    """A [H, W] or [H, W, C] dense field -> a [0, 1] RGB image (one channel
    through matplotlib's viridis)."""
    if data.ndim == 2:
        data = data[..., None]
    c = data.shape[-1]
    lo, hi = np.nanmin(data), np.nanmax(data)
    norm = (data - lo) / max(hi - lo, 1e-8)
    if c == 1:
        return pyplot("colorize_dense").get_cmap("viridis")(norm[..., 0])[..., :3]
    if c == 2:
        return np.concatenate([norm, 0.5 * np.ones_like(norm[..., :1])], -1)
    return norm[..., :3]


def colorize_quaternion(quat: np.ndarray, bg: str = "black") -> np.ndarray:
    """A quaternion field [H, W, 4] -> RGB [H, W, 3]: components from [-1, 1]
    to [0, 1], rgb = q[:3] * q[3] (visualize.py:167-216, METHOD 2), the
    all-zero quaternion of the background black or white."""
    q = np.asarray(quat, np.float32)
    norm_q = (q + 1.0) / 2.0
    rgb = norm_q[..., :3] * norm_q[..., 3:4]
    bg_val = 0.25  # (0 + 1) / 2 squared: the all-zero quaternion's colour
    is_bg = np.all(np.abs(rgb - bg_val) < 1e-7, axis=-1, keepdims=True)
    return np.where(is_bg, 0.0 if bg == "black" else 1.0, rgb)


def colorize_z(z: np.ndarray, cmap: str = "viridis") -> np.ndarray:
    """A log-depth field [H, W] -> RGB through a fixed [0, 1] norm
    (visualize.py:145-156)."""
    norm = np.clip(np.asarray(z, np.float32), 0.0, 1.0)
    return pyplot("colorize_z").get_cmap(cmap)(norm)[..., :3]


def colorize_scales(scales: np.ndarray) -> np.ndarray:
    """A scales field [H, W, 3] -> RGB directly (visualize.py:243-254)."""
    return np.clip(np.asarray(scales, np.float32), 0.0, 1.0)


def colorize_xy(xy: np.ndarray) -> np.ndarray:
    """An xy unit-vector field [H, W, 2] -> RGB with y on red and x on blue
    (visualize.py:116-128; the reference stores (y, x), the port (x, y))."""
    out = np.zeros(xy.shape[:-1] + (3,), np.float32)
    out[..., 0] = xy[..., 1]
    out[..., 2] = xy[..., 0]
    return np.clip(out, 0.0, 1.0)


def colorize_xy_angle(mask: np.ndarray, xy: np.ndarray, cmap: str = "hsv") -> np.ndarray:
    """An xy field -> hue by the vector's angle, on the foreground
    (visualize.py:85-105)."""
    angle = np.arctan2(xy[..., 0], xy[..., 1])
    lo, hi = float(angle.min()), float(angle.max())
    norm = (angle - lo) / max(hi - lo, 1e-8)
    rgb = pyplot("colorize_xy_angle").get_cmap(cmap)(norm)[..., :3]
    return np.where(np.asarray(mask)[..., None] == 0, 0.0, rgb)


def _clamp_pts(pts: np.ndarray, h: int, w: int, shift: int = 5) -> np.ndarray:
    """Points outside the frame pulled just inside its border, so that they
    stay visible (visualize.py:352-370)."""
    pts = np.asarray(pts).astype(np.int64).copy()
    pts[..., 0] = np.clip(pts[..., 0], shift, w - shift)
    pts[..., 1] = np.clip(pts[..., 1], shift, h - shift)
    return pts


def _draw_pts(img: np.ndarray, pts: np.ndarray, color, t: int = 1):
    """Square dots of half-size t at integer (x, y) points (visualize.py:372-399)."""
    h, w, _ = img.shape
    for x, y in _clamp_pts(pts, h, w).reshape(-1, 2):
        img[max(y - t, 0):y + t + 1, max(x - t, 0):x + t + 1] = color
    return img


def visualize_hough_voting(mask: np.ndarray, hypothesis: np.ndarray,
                           pruned_hypothesis: np.ndarray, winner_xy: np.ndarray) -> np.ndarray:
    """The hypothesis cloud: the mask white, hypotheses blue, pruned ones
    green, the winner red (visualize.py:296-349)."""
    h, w = mask.shape
    img = np.zeros((h, w, 3), np.float32)
    img[np.asarray(mask) != 0] = 1.0
    img = _draw_pts(img, hypothesis, (0.0, 0.0, 1.0), t=2)
    img = _draw_pts(img, pruned_hypothesis, (0.0, 1.0, 0.0), t=1)
    return _draw_pts(img, np.asarray(winner_xy)[None], (1.0, 0.0, 0.0), t=3)


def qv_mult(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Vector(s) v [..., 3] rotated by quaternion(s) q [..., 4] (xyzw)."""
    q = np.asarray(q, np.float64)
    v = np.broadcast_to(np.asarray(v, np.float64), q.shape[:-1] + (3,))
    qv, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def plot_quaternions(qs: np.ndarray, name: Optional[str] = None, remove_grid: bool = False):
    """A 3D quiver of the body axes rotated by each quaternion
    (visualize.py:1272-1349)."""
    plt = pyplot("plot_quaternions")
    qs = np.atleast_2d(np.asarray(qs))
    origin = np.zeros((qs.shape[0], 3))
    fig = plt.figure(figsize=plt.figaspect(1))
    if name:
        fig.suptitle(name)
    ax = fig.add_subplot(111, projection="3d")
    if remove_grid:
        ax.axis("off")
    ax.set_xlim3d(-1.25, 1.25)
    ax.set_ylim3d(-1.25, 1.25)
    ax.set_zlim3d(-1.25, 1.25)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    for axis, c in zip(np.eye(3), ("red", "blue", "green")):
        r = qv_mult(qs, axis)
        ax.quiver(origin[:, 0], origin[:, 1], origin[:, 2], r[:, 0], r[:, 1], r[:, 2],
                  color=c, alpha=1, arrow_length_ratio=0.1, normalize=True, length=1.1)
    ax.view_init(azim=60, elev=30)
    return fig


def compare_all_performance(image: np.ndarray, categorical: Dict[str, np.ndarray],
                            num_classes: int, gt_mask: Optional[np.ndarray] = None,
                            matched: Optional[Dict[str, np.ndarray]] = None,
                            aggregated: Optional[Dict[str, np.ndarray]] = None,
                            intrinsics: Optional[np.ndarray] = None):
    """The qualitative grids (gt_fig, pred_fig, poses_fig) of one image
    (visualize.py:1045-1139); `categorical`, `matched` and `aggregated` hold
    one image's values."""
    pyplot("compare_all_performance")
    gt_images = {"rgb": image}
    if gt_mask is not None:
        gt_images["gt_mask"] = colorize_mask(gt_mask, num_classes)
    pred_images = {
        "pred_mask": colorize_mask(categorical["mask"], num_classes),
        "pred_z": colorize_z(categorical["z"]),
        "pred_scales": colorize_scales(categorical["scales"]),
        "pred_quat": colorize_quaternion(categorical["quaternion"]),
        "pred_xy": colorize_xy_angle(categorical["mask"], categorical["xy"]),
    }
    if aggregated is not None and "hypothesis" in aggregated:
        valid = np.asarray(aggregated["valid"])
        slot = int(np.argmax(valid)) if valid.any() else 0
        pred_images["pred_hv"] = visualize_hough_voting(
            np.asarray(categorical["mask"]), aggregated["hypothesis"][slot],
            aggregated.get("pruned_hypothesis", aggregated["hypothesis"])[slot],
            aggregated["xy"][slot])
    if matched is not None and intrinsics is not None:
        pose = compare_pose_performance(image, matched["gt_RT"], matched["gt_scales"],
                                        matched["pred_RT"], matched["pred_scales"],
                                        matched["valid"], intrinsics)
    else:
        pose = image
    return (make_summary_figure(**gt_images), make_summary_figure(**pred_images),
            make_summary_figure(poses=pose))


def make_summary_figure(**images):
    """The images side by side, titled by their names (visualize.py:404-458)."""
    plt = pyplot("make_summary_figure")
    n = len(images)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    if n == 1:
        axes = [axes]
    for ax, (name, img) in zip(axes, images.items()):
        ax.imshow(np.asarray(img))
        ax.set_title(name)
        ax.axis("off")
    fig.tight_layout()
    return fig


def visualize_hypothesis(image: np.ndarray, centers: np.ndarray, valid: np.ndarray,
                         gt_centers: Optional[np.ndarray] = None) -> np.ndarray:
    """Voted centres [N, 2] (x, y) as filled red dots, and GT centres as
    green rings, over the image (visualize.py:296-399)."""
    cv2 = need("cv2", "visualize_hypothesis")
    img = (np.asarray(image) * 255).astype(np.uint8).copy()
    for i in range(centers.shape[0]):
        if not valid[i]:
            continue
        cv2.circle(img, (int(centers[i, 0]), int(centers[i, 1])), 4, (255, 0, 0), -1)
        if gt_centers is not None:
            cv2.circle(img, (int(gt_centers[i, 0]), int(gt_centers[i, 1])), 4,
                       (0, 255, 0), 1)
    return img.astype(np.float32) / 255.0


def compare_pose_performance(image: np.ndarray, gt_RTs: np.ndarray, gt_scales: np.ndarray,
                             pred_RTs: np.ndarray, pred_scales: np.ndarray,
                             valid: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """GT (green) and predicted (red) boxes and axes on one image
    (compare_pose_performance_v5, visualize.py:985-1040)."""
    need("cv2", "compare_pose_performance")
    img = (np.asarray(image) * 255).astype(np.uint8)
    for i in range(gt_RTs.shape[0]):
        if not valid[i]:
            continue
        img = draw.draw_RT(img, gt_RTs[i], gt_scales[i], intrinsics, (0, 255, 0))
        img = draw.draw_RT(img, pred_RTs[i], pred_scales[i], intrinsics, (255, 0, 0))
    return img.astype(np.float32) / 255.0


def plot_aps(aps: Dict[str, Dict[str, np.ndarray]], thresholds: Dict[str, np.ndarray],
             titles: Dict[str, str], x_labels: Dict[str, str], cls_names: Sequence[str]):
    """AP against threshold, one subplot a metric (visualize.py:1231-1267)."""
    plt = pyplot("plot_aps")
    keys = list(aps.keys())
    fig, axes = plt.subplots(1, len(keys), figsize=(5 * len(keys), 4))
    if len(keys) == 1:
        axes = [axes]
    for ax, key in zip(axes, keys):
        xs = np.asarray(thresholds[key])
        for name in cls_names:
            if name in aps[key]:
                ax.plot(xs, 100 * np.asarray(aps[key][name]), label=name)
        ax.set_title(titles.get(key, key))
        ax.set_xlabel(x_labels.get(key, ""))
        ax.set_ylabel("AP %")
        ax.set_ylim(0, 100)
        ax.grid(alpha=0.3)
    axes[-1].legend(fontsize=8)
    fig.tight_layout()
    return fig


def figure_to_array(fig) -> np.ndarray:
    """The figure rendered as uint8 RGB [H, W, 3]; the figure is closed."""
    plt = pyplot("figure_to_array")
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return buf

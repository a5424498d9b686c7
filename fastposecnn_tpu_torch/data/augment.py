"""Data augmentation for pose training: a copy of the JAX package's
`data/augment.py` (the reference's as-designed albumentations compose,
FPC/tools/transforms/pose_regression.py:33-68, applied at sample level with
the perspective warp pushed through the masks, depth and GT centres).

  train compose (`augment_sample`): perspective (p 0.5; image bilinear,
      masks and depth nearest, xy through the homography, T and the RT
      translation recomputed from the warped xy), then `apply_photometric`:
      noise (p 0.2) -> OneOf{CLAHE, brightness, gamma} (p 0.9) ->
      OneOf{sharpen, blur, motion blur} (p 0.9) -> OneOf{contrast, HSV}
      (p 0.9); the quaternion is left as it is.
  validation (`augment_validation`): noise (p 0.2) alone.

Every operator draws its random parameters before it dispatches, so the
numpy path and the native path (`native/augment.cpp`, built by
`native/augment_lib.py`) draw the same and give bit-equal images for one
`default_rng` stream. The path is the caller's choice, by the `native`
argument: native by default, numpy only where the caller passes
`native=False`. The native library's build failing raises; nothing falls
back to numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fastposecnn_tpu_torch.native import augment_lib as _nl


@dataclasses.dataclass
class AugmentConfig:
    # Probabilities — the reference compose's structure.
    noise_p: float = 0.2
    perspective_p: float = 0.5
    group1_p: float = 0.9  # OneOf{CLAHE, brightness, gamma}
    group2_p: float = 0.9  # OneOf{sharpen, blur, motion blur}
    group3_p: float = 0.9  # OneOf{contrast, HSV}
    # Magnitudes — albumentations defaults in [0,1] image units.
    noise_scale: tuple = (0.01, 0.05)
    perspective_scale: tuple = (0.05, 0.1)
    clahe_clip_limit: float = 4.0
    clahe_tiles: int = 8
    brightness_limit: float = 0.2
    gamma_limit: tuple = (0.8, 1.2)
    sharpen_alpha: tuple = (0.2, 0.5)
    sharpen_lightness: tuple = (0.5, 1.0)
    blur_k: int = 3
    contrast_limit: float = 0.2
    hue_shift: float = 20.0 / 360.0
    sat_shift: float = 30.0 / 255.0
    val_shift: float = 20.0 / 255.0


# -- color-space helpers ----------------------------------------------------


def _rgb_to_hsv(img):
    """Single-division piecewise hue (the classic 3-division/18-where
    formulation cost ~60 ms per 480x640 frame; this one ~25 ms — these run
    per sample inside loader workers, see scripts/bench_loader.py)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-8), 0.0)
    dd = np.maximum(delta, 1e-8)
    h = np.where(
        r == maxc,
        (g - b) / dd,
        np.where(g == maxc, (b - r) / dd + 2.0, (r - g) / dd + 4.0),
    )
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)
    return np.stack([h, s, maxc], axis=-1)


def _hsv_to_rgb(hsv):
    """Branch-free alternative formula: c(n) = v - v*s*clip(min(k, 4-k),
    0, 1) with k = (n + 6h) mod 6 — no per-sextant masking."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    vs = v * s

    def chan(n):
        k = (n + h * 6.0) % 6.0
        return v - vs * np.clip(np.minimum(k, 4.0 - k), 0.0, 1.0)

    return np.stack([chan(5.0), chan(3.0), chan(1.0)], axis=-1)


# -- photometric ops --------------------------------------------------------


def additive_gaussian_noise(img, rng, cfg: AugmentConfig):
    std = rng.uniform(*cfg.noise_scale)
    return img + rng.normal(0.0, std, img.shape).astype(np.float32)


def clahe(img, rng, cfg: AugmentConfig, native: bool = True):
    """Contrast-limited adaptive histogram equalization on the HSV value
    channel: per-tile clipped 256-bin histogram CDFs, bilinearly
    interpolated between tile centers (the standard CLAHE construction)."""
    if native:
        return _nl.clahe(img, cfg.clahe_tiles, cfg.clahe_clip_limit)
    hsv = _rgb_to_hsv(np.clip(img, 0.0, 1.0))
    v = hsv[..., 2]
    h, w = v.shape
    t = cfg.clahe_tiles
    vq = np.clip((v * 255.0).astype(np.int32), 0, 255)
    # Tile edges (cover the image even when h, w don't divide by t).
    ys = np.linspace(0, h, t + 1).astype(int)
    xs = np.linspace(0, w, t + 1).astype(int)
    luts = np.zeros((t, t, 256), np.float32)
    for ti in range(t):
        for tj in range(t):
            tile = vq[ys[ti]:ys[ti + 1], xs[tj]:xs[tj + 1]]
            hist = np.bincount(tile.reshape(-1), minlength=256).astype(
                np.float64
            )
            n = max(tile.size, 1)
            clip = max(cfg.clahe_clip_limit * n / 256.0, 1.0)
            excess = np.maximum(hist - clip, 0.0).sum()
            hist = np.minimum(hist, clip) + excess / 256.0
            cdf = np.cumsum(hist)
            luts[ti, tj] = (cdf / max(cdf[-1], 1.0)).astype(np.float32)
    # Bilinear interpolation between the 4 surrounding tile LUTs.
    cy = (ys[:-1] + ys[1:]) / 2.0
    cx = (xs[:-1] + xs[1:]) / 2.0
    yy = np.arange(h, dtype=np.float64)
    xx = np.arange(w, dtype=np.float64)
    fi = np.clip(np.interp(yy, cy, np.arange(t)), 0, t - 1)
    fj = np.clip(np.interp(xx, cx, np.arange(t)), 0, t - 1)
    i0 = np.floor(fi).astype(int)
    j0 = np.floor(fj).astype(int)
    i1 = np.minimum(i0 + 1, t - 1)
    j1 = np.minimum(j0 + 1, t - 1)
    wi = (fi - i0)[:, None].astype(np.float32)
    wj = (fj - j0)[None, :].astype(np.float32)
    I0 = i0[:, None]
    I1 = i1[:, None]
    J0 = j0[None, :]
    J1 = j1[None, :]
    v00 = luts[I0, J0, vq]
    v01 = luts[I0, J1, vq]
    v10 = luts[I1, J0, vq]
    v11 = luts[I1, J1, vq]
    v_eq = (
        v00 * (1 - wi) * (1 - wj)
        + v01 * (1 - wi) * wj
        + v10 * wi * (1 - wj)
        + v11 * wi * wj
    )
    hsv = hsv.copy()
    hsv[..., 2] = v_eq
    return _hsv_to_rgb(hsv)


def random_brightness(img, rng, cfg: AugmentConfig):
    return img * (1.0 + rng.uniform(-cfg.brightness_limit, cfg.brightness_limit))


def random_gamma(img, rng, cfg: AugmentConfig):
    return np.clip(img, 0.0, 1.0) ** rng.uniform(*cfg.gamma_limit)


def box_blur(img, k=3, native: bool = True):
    if k == 3 and img.dtype == np.float32 and native:
        return _nl.conv3x3(img, np.ones((3, 3), np.float32)) / (k * k)
    pad = k // 2
    padded = np.pad(img, [(pad, pad), (pad, pad), (0, 0)], mode="edge")
    out = np.zeros_like(img)
    for dy in range(k):
        for dx in range(k):
            out += padded[dy : dy + img.shape[0], dx : dx + img.shape[1]]
    return out / (k * k)


def sharpen(img, rng, cfg: AugmentConfig, native: bool = True):
    alpha = rng.uniform(*cfg.sharpen_alpha)
    lightness = rng.uniform(*cfg.sharpen_lightness)
    if img.dtype == np.float32 and native:
        return _nl.sharpen(img, alpha, lightness)
    sharpened = img + (img * lightness - box_blur(img, native=False)) * 1.0
    return img * (1 - alpha) + np.clip(sharpened, 0.0, 1.0) * alpha


def motion_blur(img, rng, cfg: AugmentConfig, native: bool = True):
    """k x k line kernel at a random angle (MotionBlur(blur_limit=3))."""
    k = cfg.blur_k
    kern = np.zeros((k, k), np.float32)
    theta = rng.uniform(0.0, np.pi)
    c = (k - 1) / 2.0
    for step in np.linspace(-c, c, 2 * k + 1):
        y = int(round(c + step * np.sin(theta)))
        x = int(round(c + step * np.cos(theta)))
        kern[y, x] = 1.0
    kern /= kern.sum()
    if k == 3 and native:
        return _nl.conv3x3(img.astype(np.float32), kern)
    pad = k // 2
    padded = np.pad(img, [(pad, pad), (pad, pad), (0, 0)], mode="edge")
    out = np.zeros_like(img)
    for dy in range(k):
        for dx in range(k):
            wgt = kern[dy, dx]
            if wgt:
                out += wgt * padded[dy : dy + img.shape[0], dx : dx + img.shape[1]]
    return out


def random_contrast(img, rng, cfg: AugmentConfig):
    alpha = rng.uniform(-cfg.contrast_limit, cfg.contrast_limit)
    mean = np.clip(img, 0.0, 1.0).mean()
    return (img - mean) * (1.0 + alpha) + mean


def hsv_jitter(img, rng, cfg: AugmentConfig, native: bool = True):
    dh = rng.uniform(-cfg.hue_shift, cfg.hue_shift)
    ds = rng.uniform(-cfg.sat_shift, cfg.sat_shift)
    dv = rng.uniform(-cfg.val_shift, cfg.val_shift)
    if native:
        return _nl.hsv_jitter(img, dh, ds, dv)
    hsv = _rgb_to_hsv(np.clip(img, 0.0, 1.0))
    hsv[..., 0] = (hsv[..., 0] + dh) % 1.0
    hsv[..., 1] = np.clip(hsv[..., 1] + ds, 0.0, 1.0)
    hsv[..., 2] = np.clip(hsv[..., 2] + dv, 0.0, 1.0)
    return _hsv_to_rgb(hsv)


# -- geometric: perspective -------------------------------------------------


def _solve_homography(src, dst):
    """8-DOF direct linear transform mapping src (4,2) -> dst (4,2)."""
    A = []
    b = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.asarray(A, np.float64), np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def sample_homography(h, w, rng, cfg: AugmentConfig):
    """Random 4-corner perspective jitter: each corner moves by
    N(0, scale)*min(h,w) px with scale ~ U(perspective_scale), the
    imgaug/IAAPerspective construction."""
    scale = rng.uniform(*cfg.perspective_scale)
    corners = np.asarray(
        [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float64
    )
    jitter = rng.normal(0.0, scale, (4, 2)) * min(h, w)
    return _solve_homography(corners, corners + jitter)


def _warp_coords(H_inv, h, w):
    # Broadcast 1-D row/col terms instead of a [H,W,3] stack @ 3x3 matmul
    # (~5x: 52 -> 10 ms per 480x640 frame).
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    Hi = H_inv.astype(np.float32)
    num_x = Hi[0, 0] * xs + (Hi[0, 1] * ys + Hi[0, 2])
    num_y = Hi[1, 0] * xs + (Hi[1, 1] * ys + Hi[1, 2])
    den = Hi[2, 0] * xs + (Hi[2, 1] * ys + Hi[2, 2])
    return num_x / den, num_y / den


def warp_image(img, H, order=1, fill=0.0, native: bool = True):
    """Inverse-map warp. order=1 bilinear (images), order=0 nearest
    (masks / depth)."""
    h, w = img.shape[:2]
    if fill == 0.0 and (order == 0 or img.dtype == np.float32) and native:
        H_inv = np.linalg.inv(H)
        if order == 0:
            return _nl.warp_nearest(img, H_inv)
        return _nl.warp_bilinear(img, H_inv)
    sx, sy = _warp_coords(np.linalg.inv(H), h, w)
    if order == 0:
        xi = np.round(sx).astype(int)
        yi = np.round(sy).astype(int)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out = np.full_like(img, fill)
        out[inside] = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)][inside]
        return out
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0).astype(np.float32)
    fy = (sy - y0).astype(np.float32)
    # Flat gathers with the out-of-bounds weight folded into the bilinear
    # weight (one multiply per tap instead of mask+clip+fancy-index
    # temporaries — ~2x on a 480x640 frame, scripts/bench_loader.py).
    flat = img.reshape(h * w, -1).astype(np.float32)

    def tap(yi, xi, wgt):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = np.clip(yi, 0, h - 1) * w + np.clip(xi, 0, w - 1)
        return flat[idx.reshape(-1)].reshape(h, w, -1) * (
            wgt * inside
        ).astype(np.float32)[..., None]

    out = (
        tap(y0, x0, (1 - fx) * (1 - fy))
        + tap(y0, x0 + 1, fx * (1 - fy))
        + tap(y0 + 1, x0, (1 - fx) * fy)
        + tap(y0 + 1, x0 + 1, fx * fy)
    )
    if img.ndim == 2:
        out = out[..., 0]
    return out.astype(img.dtype)


def warp_points(pts, H):
    """Apply H to (N, 2) pixel points."""
    hom = np.concatenate([pts, np.ones((pts.shape[0], 1))], -1) @ H.T
    return hom[:, :2] / hom[:, 2:3]


# -- composes ---------------------------------------------------------------


def apply_photometric(img, rng, cfg: AugmentConfig = None, native: bool = True):
    """The photometric part of the as-designed compose, exact OneOf
    structure: noise(0.2) -> OneOf{CLAHE,brightness,gamma}(0.9) ->
    OneOf{sharpen,blur,motion}(0.9) -> OneOf{contrast,HSV}(0.9)."""
    cfg = cfg or AugmentConfig()
    img = img.astype(np.float32)
    if rng.random() < cfg.noise_p:
        img = additive_gaussian_noise(img, rng, cfg)
    if rng.random() < cfg.group1_p:
        pick = rng.integers(3)
        if pick == 0:
            img = clahe(img, rng, cfg, native=native)
        else:
            img = [random_brightness, random_gamma][pick - 1](img, rng, cfg)
    if rng.random() < cfg.group2_p:
        pick = rng.integers(3)
        if pick == 0:
            img = sharpen(img, rng, cfg, native=native)
        elif pick == 1:
            img = box_blur(np.clip(img, 0.0, 1.0), cfg.blur_k, native=native)
        else:
            img = motion_blur(np.clip(img, 0.0, 1.0), rng, cfg, native=native)
    if rng.random() < cfg.group3_p:
        if rng.integers(2) == 0:
            img = random_contrast(img, rng, cfg)
        else:
            img = hsv_jitter(img, rng, cfg, native=native)
    return np.clip(img, 0.0, 1.0)


def augment_sample(sample, rng, cfg: AugmentConfig = None, intrinsics=None,
                   native: bool = True):
    """Full as-designed train compose at sample level.

    Geometric (perspective, p=0.5): image bilinear; mask / instance_masks /
    depth nearest (albumentations 'mask' targets + the depth
    additional_target); GT xy centers through the same homography, T and
    the RT translation column recomputed from warped xy (+ unchanged z) so
    the supervision stays mutually consistent. Photometric: image only.
    Mutates and returns `sample`."""
    cfg = cfg or AugmentConfig()
    # Dtype check, not a value heuristic: a near-black uint8 frame has
    # max <= 1 and a value test would skip the /255, then the requantize
    # would saturate it to white.
    is_uint8 = sample["image"].dtype == np.uint8
    img = sample["image"].astype(np.float32)
    if is_uint8:
        img = img / 255.0

    if rng.random() < cfg.perspective_p:
        h, w = img.shape[:2]
        H = sample_homography(h, w, rng, cfg)
        img = warp_image(img, H, order=1, native=native)
        sample["mask"] = warp_image(sample["mask"], H, order=0, native=native)
        if "depth" in sample:
            sample["depth"] = warp_image(sample["depth"], H, order=0, native=native)
        agg = sample["agg"]
        agg["instance_masks"] = np.stack(
            [warp_image(m, H, order=0, native=native) for m in agg["instance_masks"]]
        )
        valid = agg["valid"]
        if valid.any():
            new_xy = warp_points(agg["xy"], H).astype(np.float32)
            agg["xy"] = np.where(valid[:, None], new_xy, agg["xy"])
            if intrinsics is not None:
                inv_K = np.linalg.inv(intrinsics)
                z_m = agg["z"][:, None] / 1000.0  # mm -> m
                hom = np.concatenate(
                    [agg["xy"], np.ones((agg["xy"].shape[0], 1))], -1
                )
                T_new = (hom * z_m) @ inv_K.T
                agg["T"] = np.where(valid[:, None], T_new, agg["T"]).astype(
                    np.float32
                )
                # RT translation column: RT maps camera->object, so its
                # translation is -R @ T.
                t_new = -np.einsum("gij,gj->gi", agg["RT"][:, :3, :3], agg["T"])
                agg["RT"][:, :3, 3] = np.where(
                    valid[:, None], t_new, agg["RT"][:, :3, 3]
                )

    sample["image"] = apply_photometric(img, rng, cfg, native=native)
    return sample


def augment_pose_training(
    image: np.ndarray, rng: np.random.Generator, cfg: AugmentConfig = None,
    native: bool = True,
) -> np.ndarray:
    """Image-only alias of `apply_photometric` (the geometric ops need the
    full sample — use `augment_sample`, which is what
    NOCSDataset.__getitem__ calls). Public API kept for photometric-only
    callers and tests."""
    return apply_photometric(image, rng, cfg, native=native)


def augment_validation(
    image: np.ndarray, rng: np.random.Generator, cfg: AugmentConfig = None
) -> np.ndarray:
    """Validation = IAAAdditiveGaussianNoise(p=0.2) alone
    (transforms/pose_regression.py:73-77)."""
    cfg = cfg or AugmentConfig()
    if rng.random() < cfg.noise_p:
        image = additive_gaussian_noise(image.astype(np.float32), rng, cfg)
    return np.clip(image, 0.0, 1.0)


def augment_segmentation(
    image: np.ndarray,
    mask: np.ndarray,
    rng: np.random.Generator,
    cfg: AugmentConfig = None,
    native: bool = True,
):
    """Segmentation-only training may flip geometrically
    (transforms/segmentation.py:21-74) — mask transforms with the image."""
    img = apply_photometric(image, rng, cfg, native=native)
    if rng.random() < 0.5:
        img = img[:, ::-1].copy()
        mask = mask[:, ::-1].copy()
    return img, mask

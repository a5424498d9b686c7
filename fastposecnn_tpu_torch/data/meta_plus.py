"""Offline dataset preparation: a raw NOCS tree -> `*_meta+.json` ground
truth (counterpart of the JAX package's `data/meta_plus.py`; the
reference's FPC/tools/create_meta+.py).

For every raw NOCS image it parses `*_meta.txt`, takes each instance's
scales from the object-model library (or a given table, or the extent of
its visible NOCS coordinates), aligns its RT from the coord and depth maps
with the closed-form Umeyama similarity (what NOCS' `utils.align` does,
implemented here), orthogonalizes it to a quaternion and a normalizing
factor, and writes {instance_dict, scales, RTs, norm_factors,
quaternions}, the files the port's `data.nocs.NOCSDataset` reads.

Host numpy in float64, as in the JAX package; scipy's `Rotation` gives the
quaternion. The mask, coord and depth PNGs are read with the port's own
codec (`data/png.py`: 8-bit gray, RGB and RGBA, 16-bit gray), not PIL.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.spatial.transform

from fastposecnn_tpu_torch.data.nocs import standardize_depth
from fastposecnn_tpu_torch.data.png import decode_png


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform src -> dst (Umeyama, TPAMI 1991).

    src, dst: [N, 3]. Returns (scale s, rotation R [3, 3], translation t
    [3]) with dst ~= s * R @ src + t."""
    n = src.shape[0]
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / n
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (sc**2).sum() / n
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def align_instance(
    coord: np.ndarray,  # [H, W, 3] NOCS coordinate map (0..1)
    depth_mm: np.ndarray,  # [H, W] uint16 depth in mm
    mask: np.ndarray,  # [H, W] bool instance mask
    intrinsics: np.ndarray,
    max_points: int = 5000,
    seed: int = 0,
) -> Optional[Tuple[float, np.ndarray]]:
    """The instance's RT from its NOCS coordinates and observed depth:
    (scale factor, RT [4, 4], world -> camera like the meta+ RTs), or None
    with fewer than 9 valid points. At most `max_points` points, drawn
    without replacement from `default_rng(seed)`."""
    ys, xs = np.nonzero(mask & (depth_mm > 0))
    if ys.shape[0] < 9:
        return None
    if ys.shape[0] > max_points:
        sel = np.random.default_rng(seed).choice(ys.shape[0], max_points, replace=False)
        ys, xs = ys[sel], xs[sel]

    z = depth_mm[ys, xs].astype(np.float64) / 1000.0
    inv_K = np.linalg.inv(intrinsics)
    pix = np.stack([xs * z, ys * z, z], axis=-1)
    cam = (inv_K @ pix.T).T  # [N, 3] camera-space points (metres)

    nocs = coord[ys, xs].astype(np.float64) - 0.5  # centred model coordinates

    s, R, t = umeyama(nocs, cam, with_scale=True)
    # inv(RT) maps object -> camera (geometry.project_to_image): build it,
    # then invert.
    inv_RT = np.eye(4)
    inv_RT[:3, :3] = s * R
    inv_RT[:3, 3] = t
    return s, np.linalg.inv(inv_RT)


def rt_to_quat(RT: np.ndarray, normalize: bool = True):
    """RT -> (quaternion xyzw, translation, normalizing factor): the largest
    element is scaled out first so that the rotation block orthogonalizes
    cleanly (FPC/tools/data_manipulation.py:1080-1120, `RT_2_quat`)."""
    RT = np.array(RT, np.float64)
    if normalize:
        factor = float(np.amax(RT))
        RT[:3, :] = RT[:3, :] / factor
    else:
        factor = 1.0
    quat = scipy.spatial.transform.Rotation.from_matrix(RT[:3, :3]).as_quat()
    return quat, RT[:3, 3], factor


def parse_meta_txt(path) -> Dict[int, Dict]:
    """NOCS `*_meta.txt`: CAMERA lines `inst_id class_id symmetry_id
    reference_id`, REAL lines `inst_id class_id model_name`. The tokens
    after class_id are kept in 'model_tokens'."""
    out = {}
    for line in pathlib.Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) < 2:
            continue
        out[int(parts[0])] = {
            "class_id": int(parts[1]),
            "model": parts[2] if len(parts) > 2 else None,
            "model_tokens": tuple(parts[2:]),
        }
    return out


def obj_model_scale(obj_models_dir, model_tokens,
                    dataset_name: str = "CAMERA") -> Optional[np.ndarray]:
    """An instance's 3D-bbox scale from the object-model library, or None
    when its file is absent:
      CAMERA: `<dir>/<symmetry_id>/<reference_id>/bbox.txt` holds two
        corner rows; scale = bbox[0] - bbox[1];
      REAL: `<dir>/<model_name>.txt` holds one 3-vector, L2-normalized."""
    if obj_models_dir is None or not model_tokens:
        return None
    d = pathlib.Path(obj_models_dir)
    if dataset_name == "REAL":
        fp = d / f"{model_tokens[0]}.txt"
        if not fp.exists():
            return None
        v = np.loadtxt(str(fp), dtype=np.float64).reshape(-1)[:3]
        return v / np.linalg.norm(v)
    if len(model_tokens) < 2:  # CAMERA needs symmetry_id and reference_id
        return None
    fp = d / model_tokens[0] / model_tokens[1] / "bbox.txt"
    if not fp.exists():
        return None
    bbox = np.loadtxt(str(fp), dtype=np.float64)
    return bbox[0, :] - bbox[1, :]


def create_meta_plus_for_sample(
    color_fp: pathlib.Path,
    intrinsics: np.ndarray,
    model_scales: Optional[Dict[str, np.ndarray]] = None,
    obj_models_dir=None,
    dataset_name: str = "CAMERA",
) -> Optional[dict]:
    """One meta+ dict from the raw NOCS files beside `color_fp`
    (`*_mask.png`, `*_coord.png`, `*_depth.png`, `*_meta.txt`), or None if
    one is missing or no instance aligns. Scales come from, in order:
    `obj_models_dir` (`obj_model_scale`), `model_scales` (model id -> [3]
    extents), else the instance's visible NOCS extent times its scale."""
    base = str(color_fp).replace("_color.png", "")
    paths = {k: pathlib.Path(f"{base}_{k}.png") for k in ("mask", "coord", "depth")}
    meta_txt = pathlib.Path(f"{base}_meta.txt")
    if not all(p.exists() for p in paths.values()) or not meta_txt.exists():
        return None

    mask = decode_png(paths["mask"])
    if mask.ndim == 3:
        mask = mask[:, :, 0]
    coord = decode_png(paths["coord"]).astype(np.float64) / 255.0
    # NOCS coord maps store z flipped (NOCS convention).
    coord = coord[:, :, :3]
    coord[:, :, 2] = 1.0 - coord[:, :, 2]
    depth = standardize_depth(decode_png(paths["depth"]))

    meta = {"instance_dict": {}, "scales": [], "RTs": [], "norm_factors": [],
            "quaternions": []}
    for iid, info in parse_meta_txt(meta_txt).items():
        imask = mask == iid
        if not imask.any():
            continue
        res = align_instance(coord, depth, imask, intrinsics)
        if res is None:
            continue
        s, RT = res
        quat, _T, factor = rt_to_quat(RT.copy())
        scales = obj_model_scale(obj_models_dir, info["model_tokens"], dataset_name)
        if scales is None and model_scales and info["model"] in model_scales:
            scales = np.asarray(model_scales[info["model"]], np.float64)
        if scales is None:
            pts = coord[imask] - 0.5
            scales = (pts.max(axis=0) - pts.min(axis=0)) * s
        meta["instance_dict"][str(iid)] = info["class_id"]
        meta["scales"].append(scales.tolist())
        meta["RTs"].append(RT.tolist())
        meta["norm_factors"].append(factor)
        meta["quaternions"].append(np.asarray(quat).tolist())
    if not meta["instance_dict"]:
        return None
    return meta


def create_meta_plus_dataset(root, intrinsics, model_scales=None, overwrite=False,
                             obj_models_dir=None, dataset_name: str = "CAMERA") -> int:
    """Walk a raw NOCS tree and write `*_meta+.json` beside each colour
    image that has none (or every one, with `overwrite`); returns the
    number written (create_meta+.py:602-696)."""
    root = pathlib.Path(root)
    count = 0
    for color_fp in sorted(root.rglob("*_color.png")):
        out_fp = pathlib.Path(str(color_fp).replace("_color.png", "_meta+.json"))
        if out_fp.exists() and not overwrite:
            continue
        meta = create_meta_plus_for_sample(color_fp, intrinsics, model_scales,
                                           obj_models_dir=obj_models_dir,
                                           dataset_name=dataset_name)
        if meta is None:
            continue
        out_fp.write_text(json.dumps(meta))
        count += 1
    return count

"""Build the host augmentation operators (`augment.cpp` beside this file)
with `g++` and bind them with `ctypes` (counterpart of the `aug_*` wrappers
of the JAX package's `data/native_loader.py`).

The library is compiled at first use (`load_library()`), never at import,
into `fastposecnn_tpu_torch/_build/`, named by a hash of the source, the
flags and `g++ --version`; it is written under a temporary name and moved
into place with `os.replace`, so a killed build leaves no half-written
file and a later run reuses it. `-ffp-contract=off` keeps the operators
bit-equal to their numpy references in `data/augment.py`: a fused
multiply-add rounds once where numpy rounds twice. A failed build or load
raises; nothing falls back to numpy.

Each wrapper takes and returns numpy arrays; the C calls release the GIL,
so loader threads run them in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

NATIVE_DIR = pathlib.Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "augment.cpp"
BUILD_DIR = NATIVE_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native",
             "-ffp-contract=off", "-shared")
BUILD_TIMEOUT_S = 300

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def find_cxx() -> str:
    """`$CXX`, else `g++` on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH): it builds "
                           "fastposecnn_tpu_torch's native augmentation operators")
    return cxx


def library_path(cxx: str) -> pathlib.Path:
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             timeout=60, check=False).stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(version.encode())
    return BUILD_DIR / f"libfpcnn_augment_{h.hexdigest()[:16]}.so"


def _compile(cxx: str, target: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR, prefix="tmp-") as tmp:
        tmp_lib = pathlib.Path(tmp) / target.name
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp_lib)],
                              capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_lib, target)


def load_library() -> ctypes.CDLL:
    """Build (once) and load the library; set every entry point's argtypes."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = find_cxx()
        path = library_path(cxx)
        if not path.is_file():
            _compile(cxx, path)
        lib = ctypes.CDLL(str(path))
        i, f = ctypes.c_int, ctypes.c_float
        lib.fpcnn_aug_hsv_jitter.argtypes = [_F32P, i, i, f, f, f]
        lib.fpcnn_aug_clahe.argtypes = [_F32P, i, i, i, f]
        lib.fpcnn_aug_warp_bilinear.argtypes = [_F32P, _F32P, i, i, i, _F64P]
        lib.fpcnn_aug_warp_nearest.argtypes = [_U8P, _U8P, i, i, i, i, _F64P]
        lib.fpcnn_aug_conv3x3.argtypes = [_F32P, _F32P, i, i, i, _F32P, f]
        lib.fpcnn_aug_sharpen.argtypes = [_F32P, _F32P, i, i, i, ctypes.c_double,
                                          ctypes.c_double]
        for fn in (lib.fpcnn_aug_hsv_jitter, lib.fpcnn_aug_clahe,
                   lib.fpcnn_aug_warp_bilinear, lib.fpcnn_aug_warp_nearest,
                   lib.fpcnn_aug_conv3x3, lib.fpcnn_aug_sharpen):
            fn.restype = None
        _lib = lib
        return lib


def _with_channels(img: np.ndarray, dtype=None):
    """(contiguous [h, w, c] copy source, whether the input was [h, w])."""
    squeeze = img.ndim == 2
    src = np.ascontiguousarray(img[..., None] if squeeze else img, dtype)
    return src, squeeze


def hsv_jitter(img: np.ndarray, dh: float, ds: float, dv: float) -> np.ndarray:
    """clip -> rgb2hsv -> (h + dh) % 1, clip(s + ds), clip(v + dv) -> hsv2rgb
    on [H, W, 3] float32; a new array."""
    lib = load_library()
    out = np.ascontiguousarray(img, np.float32).copy()
    h, w = out.shape[:2]
    lib.fpcnn_aug_hsv_jitter(out.ctypes.data_as(_F32P), h, w, dh, ds, dv)
    return out


def clahe(img: np.ndarray, tiles: int, clip_limit: float) -> np.ndarray:
    """CLAHE on the HSV value channel of [H, W, 3] float32; a new array."""
    lib = load_library()
    out = np.ascontiguousarray(img, np.float32).copy()
    h, w = out.shape[:2]
    lib.fpcnn_aug_clahe(out.ctypes.data_as(_F32P), h, w, tiles, clip_limit)
    return out


def warp_bilinear(img: np.ndarray, H_inv: np.ndarray) -> np.ndarray:
    """Inverse-map bilinear warp of [H, W(, C)] float32, zero fill."""
    lib = load_library()
    src, squeeze = _with_channels(img, np.float32)
    h, w, c = src.shape
    dst = np.empty_like(src)
    hi = np.ascontiguousarray(H_inv, np.float64)
    lib.fpcnn_aug_warp_bilinear(src.ctypes.data_as(_F32P), dst.ctypes.data_as(_F32P),
                                h, w, c, hi.ctypes.data_as(_F64P))
    return dst[..., 0] if squeeze else dst


def warp_nearest(img: np.ndarray, H_inv: np.ndarray) -> np.ndarray:
    """Nearest warp (np.round half-even), zero fill, any element dtype."""
    lib = load_library()
    src, squeeze = _with_channels(img)
    h, w, c = src.shape
    dst = np.empty_like(src)
    hi = np.ascontiguousarray(H_inv, np.float64)
    lib.fpcnn_aug_warp_nearest(src.ctypes.data_as(_U8P), dst.ctypes.data_as(_U8P),
                               h, w, c, src.dtype.itemsize, hi.ctypes.data_as(_F64P))
    return dst[..., 0] if squeeze else dst


def conv3x3(img: np.ndarray, kern: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """3x3 convolution with edge padding on [H, W(, C)] float32."""
    lib = load_library()
    src, squeeze = _with_channels(img, np.float32)
    h, w, c = src.shape
    dst = np.empty_like(src)
    k = np.ascontiguousarray(kern, np.float32)
    lib.fpcnn_aug_conv3x3(src.ctypes.data_as(_F32P), dst.ctypes.data_as(_F32P),
                          h, w, c, k.ctypes.data_as(_F32P), scale)
    return dst[..., 0] if squeeze else dst


def sharpen(img: np.ndarray, alpha: float, lightness: float) -> np.ndarray:
    """img * (1 - alpha) + clip(img + img * lightness - box_blur3(img), 0, 1)
    * alpha on [H, W(, C)] float32."""
    lib = load_library()
    src = np.ascontiguousarray(img, np.float32)
    h, w = src.shape[:2]
    c = 1 if src.ndim == 2 else src.shape[2]
    dst = np.empty_like(src)
    lib.fpcnn_aug_sharpen(src.ctypes.data_as(_F32P), dst.ctypes.data_as(_F32P),
                          h, w, c, alpha, lightness)
    return dst

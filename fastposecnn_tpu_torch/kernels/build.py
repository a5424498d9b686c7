"""Build the CUDA kernels of this package with plain `nvcc` and load them
with `ctypes`.

The sources (`*.cu` beside this file) export `extern "C"` entry points that
take raw device pointers, sizes and a `cudaStream_t`, and return a
`cudaError_t`; they include no torch headers, so no `ninja`, pybind11 or
`torch.utils.cpp_extension` is involved. One `nvcc` call compiles the sources
into one shared library under `fastposecnn_tpu_torch/_build/`, named by a hash
of the sources, the flags and `nvcc --version`. The library is written under a
temporary name and moved into place with `os.replace`, so a killed build
leaves neither a lock nor a half-written file, and a later run reuses it.
`-Xptxas -v` makes the compiler report each kernel's registers, shared
memory and spills; `build_info["ptxas"]` holds them by kernel, from a file
kept beside the library, so a reused library reports them too.

Building happens at first use (`load_library()`), never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional

KERNEL_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parent / "_build"
SOURCES = ("cc_label.cu", "vote_count.cu", "vote_expanded_mma.cu",
           "vote_expanded_bcast.cu")
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-fmad=false", "-Xptxas",
              "-v", "-Xcompiler", "-fPIC", "-shared")
BUILD_TIMEOUT_S = 300

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def find_nvcc() -> str:
    """`$CUDA_HOME/bin/nvcc`, then `/usr/local/cuda/bin/nvcc`, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA toolkit is needed to build fastposecnn_tpu_torch's "
        "kernels"
    )


def _run(cmd, cwd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S, check=False)


def _library_path(nvcc: str) -> pathlib.Path:
    version = _run([nvcc, "--version"], KERNEL_DIR).stdout
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((KERNEL_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(version.encode())
    build_info["nvcc_version"] = version.strip().splitlines()[-1] if version else ""
    return BUILD_DIR / f"libfpcnn_kernels_{h.hexdigest()[:16]}.so"


def _kernel_name(mangled: str) -> str:
    """`vote_count_kernel` from an Itanium mangled name such as
    `_ZN<n>_GLOBAL__N_..._<n>vote_count_kernelEPK6float2...` (a function in
    an anonymous namespace) or `_Z<n>name...`."""
    names, i = [], 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    names = [n for n in names if not n.startswith("_GLOBAL__N")]
    return names[-1] if names else mangled


def parse_ptxas(log: str) -> Dict[str, Dict[str, object]]:
    """Registers, shared memory, stack and spills of each kernel, from the
    lines `nvcc -Xptxas -v` prints, and the compiler's warnings about a
    kernel (such as wgmma serialised) under its "notes"."""
    out: Dict[str, Dict[str, object]] = {}
    name = None
    for line in log.splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            m = re.search(r"'(_Z\w+)'", line)
            key = _kernel_name(m.group(1)) if m else "other"
            out.setdefault(key, {}).setdefault("notes", []).append(line.strip())
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                out[name][key] = int(m.group(1))
    return out


def _compile(nvcc: str, target: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR, prefix="tmp-") as tmp:
        tmp_lib = pathlib.Path(tmp) / target.name
        proc = _run([nvcc, *NVCC_FLAGS, *(str(KERNEL_DIR / s) for s in SOURCES),
                     "-o", str(tmp_lib)], tmp)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        tmp_info = pathlib.Path(tmp) / "ptxas.json"
        tmp_info.write_text(json.dumps(parse_ptxas(proc.stdout + proc.stderr)))
        os.replace(tmp_info, target.with_suffix(".ptxas.json"))
        os.replace(tmp_lib, target)


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel library; set every entry point's
    argtypes and restype."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    path = _library_path(nvcc)
    reused = path.is_file()
    if not reused:
        _compile(nvcc, path)
    info = path.with_suffix(".ptxas.json")
    build_info.update(library=str(path), reused=reused,
                      seconds=time.perf_counter() - t0,
                      ptxas=json.loads(info.read_text()) if info.is_file() else {})
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fpcnn_cc_label.argtypes = [p, p, p, i, i, i, p]
    lib.fpcnn_cc_label.restype = i
    lib.fpcnn_cc_label_empty.argtypes = [i, i, i, p]
    lib.fpcnn_cc_label_empty.restype = i
    lib.fpcnn_vote_count.argtypes = [p, p, p, p, p, p, i, i, i, ctypes.c_float, p]
    lib.fpcnn_vote_count.restype = i
    for fn in (lib.fpcnn_vote_expanded_mma, lib.fpcnn_vote_expanded_bcast):
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float, p]
        fn.restype = i
    lib.fpcnn_error_string.argtypes = [i]
    lib.fpcnn_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on any `cudaError_t` other than success."""
    if err != 0:
        msg = _lib.fpcnn_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

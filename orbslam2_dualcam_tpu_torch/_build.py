"""Build and load the package's CUDA kernels.

The sources in ``csrc/*.cu`` are compiled with nvcc into one shared library
with a plain C interface, at first use, into ``_build/`` beside this file
(listed in .gitignore).  The library's name carries a hash of the sources
and flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing here runs at import time: the CPU tests import every
module on machines without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of orbslam2_dualcam_tpu_torch are compiled from csrc/ at "
        "first use on a CUDA tensor and need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.
    The compiler's output (with ptxas register and shared-memory use) is
    kept in the library's ``.log`` file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(SRC_DIR.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pp, pi = ctypes.POINTER(p), ctypes.POINTER(i)
    lib.fast_nms_levels_f32.argtypes = [i, pp, pp, pp, pi, pi, pi, f, f, p]
    lib.fast_nms_levels_f32.restype = i
    lib.fast_nms_max_levels.argtypes = []
    lib.fast_nms_max_levels.restype = i
    lib.kernels_error_string.argtypes = [i]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    if status != 0:
        msg = lib.kernels_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} ({msg})")

"""ctypes wrapper for the C++ inverted-file index (invfile.cpp, the same
source as the JAX package's, byte for byte).

Compiled with ``g++ -O2 -shared -fPIC -std=c++17`` at first use into
``_build/`` beside the package (listed in .gitignore), under a name that
carries a hash of the source and flags, so an edited source is rebuilt and
a stale library is never loaded.  Nothing is built at import time.  A
failed build raises RuntimeError with g++'s message."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict

import numpy as np

SRC = Path(__file__).resolve().parent / "invfile.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libinvfile_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile invfile.cpp unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {SRC.name}:"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.invfile_create.restype = p
    lib.invfile_create.argtypes = [i, i]
    lib.invfile_destroy.argtypes = [p]
    lib.invfile_add.argtypes = [p, i64, i, p, i]
    lib.invfile_erase.argtypes = [p, i64]
    lib.invfile_clear.argtypes = [p]
    lib.invfile_query.restype = i
    lib.invfile_query.argtypes = [p, i, p, i, p, i, p, p, i]
    return lib


class NativeInvertedFile:
    """Per-camera word -> keyframe postings with shared-word queries."""

    def __init__(self, n_cameras: int, n_words: int, cap: int = 4096):
        self._lib = load_library()
        self._h = self._lib.invfile_create(n_cameras, n_words)
        self._cap = cap

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.invfile_destroy(self._h)
            self._h = None

    def add(self, kid: int, cam: int, words: np.ndarray) -> None:
        w = np.ascontiguousarray(words, np.int32)
        self._lib.invfile_add(self._h, kid, cam, w.ctypes.data, len(w))

    def erase(self, kid: int) -> None:
        self._lib.invfile_erase(self._h, kid)

    def clear(self) -> None:
        self._lib.invfile_clear(self._h)

    def query(self, resp_cam: int, words: np.ndarray,
              exclude=()) -> Dict[int, int]:
        """{kid: number of `words` shared with camera `resp_cam` of kid},
        in the index's own order, without the kids in `exclude`."""
        w = np.ascontiguousarray(words, np.int32)
        ex = np.ascontiguousarray(list(exclude), np.int64)
        kids = np.empty(self._cap, np.int64)
        cnts = np.empty(self._cap, np.int32)
        n = self._lib.invfile_query(self._h, resp_cam, w.ctypes.data, len(w),
                                    ex.ctypes.data, len(ex), kids.ctypes.data,
                                    cnts.ctypes.data, self._cap)
        return dict(zip(kids[:n].tolist(), cnts[:n].tolist()))

"""ctypes bindings for the native (C++) BVH builder.

The native layer mirrors the reference's use of C++ for its
performance-critical host-side runtime (scene/BVH building,
reference: externals/bvh.h + src/core/accel.h).  The library is built
from `bvh_builder.cpp` at first use, into `libbpt_native.so` beside the
source (gitignored), and rebuilt when the source is newer.  Without a
C++ compiler the numpy builder in accel/build.py, which produces an
identical FlatBVH, is used instead.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
LIB_PATH = os.path.join(_DIR, "libbpt_native.so")
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_LIB = None
_TRIED = False


def _build() -> bool:
    """Compile LIB_PATH from source; False when no C++ compiler exists.

    The library is written under a temporary name and renamed into
    place, so processes building at the same time never load a partial
    file."""
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    stale = (not os.path.exists(LIB_PATH)
             or os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC))
    if stale and not _build():
        return None
    lib = ctypes.CDLL(LIB_PATH)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bpt_bvh_build.restype = ctypes.c_int64
    lib.bpt_bvh_build.argtypes = [ctypes.c_int64, f32p, f32p, f32p]
    lib.bpt_bvh_export.restype = None
    lib.bpt_bvh_export.argtypes = [f32p, f32p, i32p, i32p, i32p, i32p]
    lib.bpt_bvh_free.restype = None
    lib.bpt_bvh_free.argtypes = []
    _LIB = lib
    return _LIB


def available() -> bool:
    """True when the native builder is (or can be) built and loaded."""
    return _load() is not None


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    """Native BVH build; returns the same FlatBVH as accel.build.build_bvh
    or None when no C++ compiler is available."""
    lib = _load()
    if lib is None:
        return None
    from ..accel.build import FlatBVH

    t = len(v0)
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    n = int(lib.bpt_bvh_build(t, v0, v1, v2))
    bmin = np.empty((n, 3), np.float32)
    bmax = np.empty((n, 3), np.float32)
    miss = np.empty(n, np.int32)
    start = np.empty(n, np.int32)
    count = np.empty(n, np.int32)
    prim_order = np.empty(t, np.int32)
    lib.bpt_bvh_export(bmin, bmax, miss, start, count, prim_order)
    lib.bpt_bvh_free()
    return FlatBVH(bmin=bmin, bmax=bmax, miss=miss, start=start,
                   count=count, prim_order=prim_order)

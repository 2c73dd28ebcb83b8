"""ctypes bridge to the native C++ SAH BVH builder.

The source is the port's own copy, ``csrc/bvh_builder.cpp``, of the JAX
package's C++ file, compiled with the JAX package's g++ flags; a test holds
the two files byte-equal, so the packages cannot drift apart. The library
goes to the port's ``csrc/_build/`` and is rebuilt when the source is newer
than it.

Unlike the JAX package, a failed build raises: the builder decides ``perm``,
and ``perm`` decides both the tie order of the closest-hit queries and their
speed, so a silent switch to the numpy builder would change results.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .build import FlatBVH, build_bvh as build_bvh_numpy, from_arrays

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "bvh_builder.cpp")
LIB_PATH = os.path.join(_PKG, "csrc", "_build", "libptxbvh.so")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
NATIVE_THRESHOLD = 20000

_lock = threading.Lock()
_lib = None


def _compile() -> None:
    if not os.path.exists(SRC):
        raise RuntimeError(f"BVH builder source missing: {SRC}")
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC)):
        return
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, SRC, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"BVH builder build failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"BVH builder build failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIB_PATH)


def load() -> ctypes.CDLL:
    """The builder library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _compile()
            lib = ctypes.CDLL(LIB_PATH)
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.ptx_build_bvh.argtypes = [
                f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
                f32p, f32p, i32p, i32p, i32p, i32p, ctypes.c_int]
            lib.ptx_build_bvh.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_bvh_native(v0, v1, v2, leaf_size: int = 8) -> FlatBVH:
    """SAH BVH through the C++ builder; raises if it cannot be built or
    fails."""
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    T = v0.shape[0]
    if T == 0:
        raise ValueError("no triangles to build a BVH over")
    lib = load()
    max_nodes = 2 * T + 8
    bmin = np.empty((max_nodes, 3), np.float32)
    bmax = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    escape = np.empty(max_nodes, np.int32)
    perm = np.empty(T, np.int32)
    n = lib.ptx_build_bvh(v0, v1, v2, T, leaf_size, bmin, bmax, first,
                          count, escape, perm, max_nodes)
    if n <= 0:
        raise RuntimeError(f"native BVH build failed ({n}) on {T} triangles")
    return from_arrays(bmin[:n], bmax[:n], first[:n], count[:n], escape[:n],
                       perm, leaf_size)


def build_bvh_auto(v0, v1, v2, leaf_size: int = 8,
                   native_threshold: int = NATIVE_THRESHOLD) -> FlatBVH:
    """The numpy builder below ``native_threshold`` triangles, the C++ SAH
    builder from there up (the JAX package's rule)."""
    if np.asarray(v0).shape[0] >= native_threshold:
        return build_bvh_native(v0, v1, v2, leaf_size=leaf_size)
    return build_bvh_numpy(v0, v1, v2, leaf_size=leaf_size)

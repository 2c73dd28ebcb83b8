"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own nvcc, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library goes to ``csrc/_build/`` and
is rebuilt when a source is newer than it. Only the repository's sources
are used; a failed build raises and never falls back.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` so that ``a*b + c`` is not
contracted into an FMA and the kernels agree bit for bit with their plain
torch versions (whose elementwise ops round after every operation), and no
``-use_fast_math``, so division stays IEEE.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
BUILD_DIR = os.path.join(_CSRC, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libpbrkernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None

# None, or the list into which every kernel wrapper appends (kernel, shapes)
# where it launches: ``utils.roofline.record_launches`` opens one
launch_records = None

_p = ctypes.c_void_p
_i = ctypes.c_int
_SIGNATURES = {
    # ro, rd, t_lower, alive, tris, boxes, perm, n, n_tris, chunk,
    # out_hit, out_i, out_t, out_u, out_v, stream
    "pbr_intersect_dense": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                            _p, _p, _p, _p, _p, _p],
    # ro, rd, t_lower, alive, nodes, tris, pos, perm, n, n_nodes,
    # out_hit, out_i, out_t, out_u, out_v, stream
    "pbr_intersect_bvh": [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i,
                          _p, _p, _p, _p, _p, _p],
    # the same, with out_nodes, out_tris before the stream
    "pbr_intersect_bvh_stats": [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i,
                                _p, _p, _p, _p, _p, _p, _p, _p],
    # idx, table, n, n_rows, width, out, stream
    "pbr_packgather_fwd": [_p, _p, _i, _i, _i, _p, _p],
    # idx, cot, n, n_rows, width, sort_tile, chunk, passes, scratch_i,
    # scratch_d, out, stream
    "pbr_packgather_bwd": [_p, _p, _i, _i, _i, _i, _i, _i, _p, _p, _p, _p],
    # &ShadeArgs, stream (kernels/shade.py)
    "pbr_shade_s1": [_p, _p],
    "pbr_shade_s2": [_p, _p],
    "pbr_shade_s3": [_p, _p],
    # slot, stream, out node (utils/observability.py's device spans)
    "pbr_stamp": [_p, _p, ctypes.POINTER(_p)],
    # graph exec, nodes, n, enable
    "pbr_nodes_enable": [_p, ctypes.POINTER(_p), _i, _i],
}


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile the kernels if the library is missing or older than a
    source. Returns the compiler's output (ptxas register and shared-memory
    report), or "" when the library was up to date."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    newest = max(os.path.getmtime(s) for s in sources)
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest:
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    jobs = []
    for src in (s for s in sources if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR,
                           f"{os.path.basename(src)}.{pid}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = ""
    failed = []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log += out
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = f"{LIB_PATH}.{pid}.tmp"
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        link = subprocess.run(cmd, capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{' '.join(cmd)}\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return log + link.stdout + link.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

"""Dense closest-hit query: the CUDA kernel ``csrc/intersect.cu`` and its
plain torch version.

Replaces ``pbrpathtracer_tpu/kernels/intersect_pallas.py`` (``_run``, the
dense route of ``intersect_pallas``). The contract is the same:
``intersect_dense(geom, ro, rd, t_lower, alive, perm=None)`` returns
(hit bool[N], idx i32[N], t f32[N], u f32[N], v f32[N]); a miss or a dead
lane is a clean miss (hit False, idx = t = u = v = 0); ties go to the lowest
triangle id (in ``perm`` order when a permutation is given).

Tensors on the CPU take the plain version; CUDA tensors launch the kernel.
The wrapper refuses scenes of more than ``MAX_DENSE_CHUNKS`` chunks (2048
triangles): those take the BVH kernel (``kernels/intersect_list.py``), as the
JAX wrapper routes them to its candidate-list kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.scene import Geometry
from ..ops.intersect import BIG, intersect_classic
from ..utils.constants import EPS
from . import native

MAX_CHUNK = 512          # triangles staged in shared memory per step
MAX_DENSE_CHUNKS = 4


def _chunking(n_tris: int):
    """(chunk, n_chunks): chunks of at most MAX_CHUNK triangles."""
    chunk = min(MAX_CHUNK, max(8, (n_tris + 7) // 8 * 8))
    return chunk, (n_tris + chunk - 1) // chunk


def dense_chunks(n_tris: int) -> int:
    """Chunks of the dense route; more than MAX_DENSE_CHUNKS take K4."""
    return _chunking(n_tris)[1]


def check_query(geom, ro, rd, t_lower, alive):
    """Shapes, types, devices and layout of a closest-hit query."""
    N = ro.shape[0]
    if ro.shape != (N, 3) or rd.shape != (N, 3):
        raise ValueError(f"ro/rd must be [N, 3], got {tuple(ro.shape)} "
                         f"and {tuple(rd.shape)}")
    if t_lower.shape != (N,) or alive.shape != (N,):
        raise ValueError("t_lower and alive must be [N]")
    for name, x, dtype in (("ro", ro, torch.float32),
                           ("rd", rd, torch.float32),
                           ("t_lower", t_lower, torch.float32),
                           ("alive", alive, torch.bool),
                           ("geom.v0", geom.v0, torch.float32),
                           ("geom.e1", geom.e1, torch.float32),
                           ("geom.e2", geom.e2, torch.float32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != ro.device:
            raise ValueError(f"{name} is on {x.device}, rays on {ro.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _permuted(geom: Geometry, perm):
    if perm is None:
        return geom.v0, geom.e1, geom.e2
    p = perm.long()
    return geom.v0[p], geom.e1[p], geom.e2[p]


def intersect_dense_plain(geom: Geometry, ro, rd, t_lower, alive, perm=None):
    """Plain torch version of the kernel (``ops.intersect.intersect_classic``
    over the ``perm``-ordered triangles)."""
    intersect_dense_plain.launches += 1
    v0, e1, e2 = _permuted(geom, perm)
    g = dataclasses.replace(geom, v0=v0, e1=e1, e2=e2)
    hit, idx, t, u, v = intersect_classic(g, ro, rd, t_lower, alive)
    if perm is not None:
        idx = torch.where(hit, perm[idx.long()], 0)
    return hit, idx, t, u, v


intersect_dense_plain.launches = 0


def _tris_and_boxes(v0, e1, e2, chunk: int, n_chunks: int):
    """Set-up pass: f32[T, 9] (v0, e1, e2) rows and f32[n_chunks, 6] chunk
    boxes (lo, hi), inflated by EPS so that flat chunks (an axis-aligned
    wall) survive the kernel's strict slab test."""
    T = v0.shape[0]
    tris = torch.cat([v0, e1, e2], dim=1).contiguous()
    v1 = v0 + e1
    v2 = v0 + e2
    lo = torch.minimum(torch.minimum(v0, v1), v2)
    hi = torch.maximum(torch.maximum(v0, v1), v2)
    pad = n_chunks * chunk - T
    lo = torch.cat([lo, lo.new_full((pad, 3), BIG)])
    hi = torch.cat([hi, hi.new_full((pad, 3), -BIG)])
    lo = lo.view(n_chunks, chunk, 3).amin(dim=1) - float(EPS)
    hi = hi.view(n_chunks, chunk, 3).amax(dim=1) + float(EPS)
    return tris, torch.cat([lo, hi], dim=1).contiguous()


def intersect_dense(geom: Geometry, ro, rd, t_lower=None, alive=None,
                    perm=None):
    """Closest-hit query through the dense kernel (CUDA tensors) or its
    plain version (CPU tensors)."""
    N = ro.shape[0]
    if t_lower is None:
        t_lower = torch.zeros(N, dtype=torch.float32, device=ro.device)
    if alive is None:
        alive = torch.ones(N, dtype=torch.bool, device=ro.device)
    check_query(geom, ro, rd, t_lower, alive)
    if dense_chunks(geom.num_triangles) > MAX_DENSE_CHUNKS:
        raise NotImplementedError(
            f"{geom.num_triangles} triangles: the dense kernel takes at most "
            f"{MAX_DENSE_CHUNKS * MAX_CHUNK}; larger scenes take "
            "kernels.intersect_list.intersect_list")
    if ro.device.type == "cpu":
        return intersect_dense_plain(geom, ro, rd, t_lower, alive, perm)
    if ro.device.type != "cuda":
        raise ValueError(f"no intersect kernel for device {ro.device}")

    T = geom.num_triangles
    chunk, n_chunks = _chunking(T)
    tris, boxes = _tris_and_boxes(*_permuted(geom, perm), chunk, n_chunks)
    out_t = torch.empty(N, dtype=torch.float32, device=ro.device)
    out_u = torch.empty_like(out_t)
    out_v = torch.empty_like(out_t)
    out_i = torch.empty(N, dtype=torch.int32, device=ro.device)
    err = native.load().pbr_intersect_dense(
        ro.data_ptr(), rd.data_ptr(), t_lower.data_ptr(), alive.data_ptr(),
        tris.data_ptr(), boxes.data_ptr(), N, T, chunk,
        out_t.data_ptr(), out_u.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), torch.cuda.current_stream(ro.device).cuda_stream)
    native.check(err, "intersect_dense")
    intersect_dense.launches += 1
    hit = out_t < BIG
    idx = out_i if perm is None else perm[out_i.long()]
    return (hit, torch.where(hit, idx, 0), torch.where(hit, out_t, 0.0),
            out_u, out_v)


intersect_dense.launches = 0

"""Closest-hit query for large scenes: the CUDA kernel ``csrc/bvh_intersect.cu``
(K4) and its plain torch version.

Replaces ``pbrpathtracer_tpu/kernels/intersect_pallas_list.py``
(``run_list_kernel``, the route ``intersect_pallas`` takes for more than four
chunks of 512 triangles). It computes what that kernel computes: per ray,
the closest Möller–Trumbore hit with t > EPS and t > t_lower; dead lanes a
clean miss (hit False, idx = t = u = v = 0); exact-t ties to the lowest
*position* in the triangle order of the JAX wrapper: the scene's BVH order
(``accel.perm``) when the scene has a BVH, scene order otherwise. Ids come
back as scene ids.

The kernel walks a BVH (one thread per ray, stackless over the escape
links); the TPU kernel's per-tile candidate lists are a TPU schedule, not
part of the function. A scene without a BVH (2049-4096 triangles under
``accel="auto"``, or ``accel="none"``) gets a private BVH for the walk,
built once and cached on its geometry; its positions stay the scene ids.

Tensors on the CPU take the plain version; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ..accel.build import FlatBVH
from ..accel.native import build_bvh_auto
from ..ops.intersect import BIG, intersect_classic
from ..scene.scene import Geometry
from ..utils.constants import EPS
from . import native
from .intersect import check_query

# Triangles per block of the plain version: its temporaries stay
# [rows, TRI_BLOCK] with rows * TRI_BLOCK <= ops.intersect.PAIR_BUDGET.
TRI_BLOCK = 8192


def intersect_list_plain(geom: Geometry, ro, rd, t_lower, alive, perm=None):
    """Plain torch version of the kernel: ``ops.intersect.intersect_classic``
    over blocks of triangles in ``perm`` order (scene order when None),
    folded into a running (t, position) minimum. Only live lanes are
    computed."""
    intersect_list_plain.launches += 1
    N, T = ro.shape[0], geom.num_triangles
    dev = ro.device
    if perm is None:
        v0, e1, e2 = geom.v0, geom.e1, geom.e2
    else:
        p = perm.long()
        v0, e1, e2 = geom.v0[p], geom.e1[p], geom.e2[p]
    live = torch.arange(N, device=dev) if alive is None else \
        alive.nonzero()[:, 0]
    lro, lrd, ltl = ro[live], rd[live], t_lower[live]
    n = live.shape[0]
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_s = torch.zeros((n,), dtype=torch.int32, device=dev)
    for s0 in range(0, T, TRI_BLOCK):
        sl = slice(s0, s0 + TRI_BLOCK)
        block = dataclasses.replace(geom, v0=v0[sl], e1=e1[sl], e2=e2[sl])
        h, i, t, u, v = intersect_classic(block, lro, lrd, ltl)
        # blocks come in position order: strict < keeps the earlier
        # position on an exact tie, argmin the lowest inside a block
        better = h & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)
        best_s = torch.where(better, i + s0, best_s)
    hit_l = best_t < BIG
    idx_l = best_s if perm is None else perm[best_s.long()]
    hit = torch.zeros(N, dtype=torch.bool, device=dev)
    idx = torch.zeros(N, dtype=torch.int32, device=dev)
    t = torch.zeros(N, dtype=torch.float32, device=dev)
    u = torch.zeros(N, dtype=torch.float32, device=dev)
    v = torch.zeros(N, dtype=torch.float32, device=dev)
    hit[live] = hit_l
    idx[live] = torch.where(hit_l, idx_l, 0)
    t[live] = torch.where(hit_l, best_t, 0.0)
    u[live] = torch.where(hit_l, best_u, 0.0)
    v[live] = torch.where(hit_l, best_v, 0.0)
    return hit, idx, t, u, v


intersect_list_plain.launches = 0


@dataclasses.dataclass(frozen=True)
class _Prepared:
    """What the kernel reads, built once per (geometry, BVH)."""

    nodes: torch.Tensor   # f32[M, 8]: lo - EPS, 0, hi + EPS, 0
    links: torch.Tensor   # i32[M, 4]: first, count, escape, 0
    tris: torch.Tensor    # f32[T, 9]: v0, e1, e2 of each slot
    pos: torch.Tensor     # i32[T]: tie-break position of each slot
    perm: torch.Tensor    # i32[T]: scene id of each slot


def _prepare(geom: Geometry, accel: FlatBVH | None) -> _Prepared:
    """The kernel's inputs for a scene, cached on its geometry. Node boxes
    are inflated by EPS, as the TPU wrapper inflates its chunk boxes, so
    that the walk never culls a box whose triangle ties the best t, and
    flat boxes (a ground plane, a quad light) survive the strict slab
    test."""
    cached = getattr(geom, "_k4_prepared", None)
    if cached is not None and cached[0] is accel:
        return cached[1]
    dev = geom.v0.device
    if accel is None:
        v0, v1, v2 = (x.cpu().numpy() for x in geom.vertices())
        bvh = build_bvh_auto(v0, v1, v2).to(dev)
        pos = bvh.perm
    else:
        bvh = accel.to(dev)
        pos = torch.arange(bvh.perm.shape[0], dtype=torch.int32, device=dev)
    if bvh.perm.shape[0] != geom.num_triangles:
        raise ValueError(f"BVH over {bvh.perm.shape[0]} triangles, scene has "
                         f"{geom.num_triangles}")
    M = bvh.num_nodes
    zero = torch.zeros((M, 1), dtype=torch.float32, device=dev)
    nodes = torch.cat([bvh.bounds_min - float(EPS), zero,
                       bvh.bounds_max + float(EPS), zero], dim=1)
    links = torch.stack([bvh.first, bvh.count, bvh.escape,
                         torch.zeros_like(bvh.first)], dim=1)
    p = bvh.perm.long()
    tris = torch.cat([geom.v0[p], geom.e1[p], geom.e2[p]], dim=1)
    prep = _Prepared(nodes=nodes.contiguous(), links=links.contiguous(),
                     tris=tris.contiguous(), pos=pos.contiguous(),
                     perm=bvh.perm.contiguous())
    object.__setattr__(geom, "_k4_prepared", (accel, prep))
    return prep


def intersect_list(geom: Geometry, ro, rd, t_lower=None, alive=None,
                   accel: FlatBVH | None = None):
    """Closest-hit query through the BVH kernel (CUDA tensors) or its plain
    version (CPU tensors). ``accel`` is the scene's BVH or None."""
    N = ro.shape[0]
    if t_lower is None:
        t_lower = torch.zeros(N, dtype=torch.float32, device=ro.device)
    if alive is None:
        alive = torch.ones(N, dtype=torch.bool, device=ro.device)
    check_query(geom, ro, rd, t_lower, alive)
    if ro.device.type == "cpu":
        return intersect_list_plain(geom, ro, rd, t_lower, alive,
                                    None if accel is None else accel.perm)
    if ro.device.type != "cuda":
        raise ValueError(f"no intersect kernel for device {ro.device}")

    prep = _prepare(geom, accel)
    hit = torch.empty(N, dtype=torch.bool, device=ro.device)
    idx = torch.empty(N, dtype=torch.int32, device=ro.device)
    t = torch.empty(N, dtype=torch.float32, device=ro.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    err = native.load().pbr_intersect_bvh(
        ro.data_ptr(), rd.data_ptr(), t_lower.data_ptr(), alive.data_ptr(),
        prep.nodes.data_ptr(), prep.links.data_ptr(), prep.tris.data_ptr(),
        prep.pos.data_ptr(), prep.perm.data_ptr(), N, prep.links.shape[0],
        hit.data_ptr(), idx.data_ptr(), t.data_ptr(), u.data_ptr(),
        v.data_ptr(), torch.cuda.current_stream(ro.device).cuda_stream)
    native.check(err, "intersect_list")
    intersect_list.launches += 1
    return hit, idx, t, u, v


intersect_list.launches = 0

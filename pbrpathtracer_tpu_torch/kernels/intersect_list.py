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

The kernel walks a 4-wide BVH, one thread per ray, near child first with a
short stack; the TPU kernel's per-tile candidate lists are a TPU schedule,
not part of the function. The wide tree is collapsed here from the scene's
binary ``FlatBVH`` (``collapse_bvh``): every interior node absorbs its
grandchildren, so a node holds up to four child boxes and, per child, a wide
node's index or a leaf of the binary tree. A scene without a BVH (2049-4096
triangles under ``accel="auto"``, or ``accel="none"``) gets a private BVH
for the walk; its positions stay the scene ids. Layout and rows are built
once per (geometry, BVH) and cached on the geometry.

Tensors on the CPU take the plain version; CUDA tensors launch the kernel.
``walk_plain`` is the kernel's walk over the kernel's layout in plain torch,
lane for lane: it holds the layout and the walk's logic where there is no
card, and no render path calls it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.build import FlatBVH
from ..accel.native import build_bvh_auto
from ..ops.intersect import (BIG, hit_tests, intersect_classic,
                             moller_trumbore)
from ..scene.scene import Geometry
from ..utils import observability
from ..utils.constants import EPS
from . import native
from .intersect import check_query

# Triangles per block of the plain version: its temporaries stay
# [rows, TRI_BLOCK] with rows * TRI_BLOCK <= ops.intersect.PAIR_BUDGET.
TRI_BLOCK = 8192
# The wide tree's layout, as csrc/bvh_intersect.cu reads it. A node is one
# record of RECORD_WORDS 4-byte words (128 bytes): lo.x, lo.y, lo.z, hi.x,
# hi.y, hi.z of its WIDTH child boxes, four floats each, then the WIDTH
# children, then four words of padding. A child is a wide node's index
# (>= 0) or a leaf, ~(first << COUNT_BITS | count); EMPTY (a leaf of
# nothing) marks an unused slot.
WIDTH = 4
RECORD_WORDS = 32
COUNT_BITS = 4
EMPTY = -1
# Entries of the kernel's per-thread stack (kStack): a walk pushes at most
# WIDTH - 1 per level.
STACK_DEPTH = 64
TINY = 1e-30


def intersect_list_plain(geom: Geometry, ro, rd, t_lower, alive, perm=None):
    """Plain torch version of the kernel: ``ops.intersect.intersect_classic``
    over blocks of triangles in ``perm`` order (scene order when None),
    folded into a running (t, position) minimum. Only live lanes are
    computed."""
    observability.count("intersect_list_plain")
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


@dataclasses.dataclass(frozen=True)
class _Prepared:
    """What the kernel reads, built once per (geometry, BVH)."""

    nodes: torch.Tensor         # i32[M, RECORD_WORDS]: the wide tree's records
    tris: torch.Tensor          # f32[T, 12]: v0, 0, e1, 0, e2, 0 of each slot
    pos: torch.Tensor | None    # i32[T]: tie-break position of each slot;
    #                             None: the slot itself
    perm: torch.Tensor          # i32[T]: scene id of each slot
    depth: int                  # levels of wide nodes
    bvh_nodes: int              # nodes of the binary BVH it was collapsed from
    leaf_size: int              # its largest leaf


def collapse_bvh(bounds_min, bounds_max, first, count, escape):
    """The 4-wide tree of a binary ``FlatBVH`` given as numpy arrays:
    ``(records i32[M, RECORD_WORDS], depth)``.

    The binary root becomes wide node 0. A wide node made from binary node i
    takes i's children (i + 1 and escape[i + 1]) and puts each interior one's
    own two children in its place, so it has two to four children: binary
    leaves, kept as they are, and binary interior nodes, which become wide
    nodes in turn. Nodes are numbered level by level (the top of the tree
    lies first), each level built at once from the one above. Child boxes
    are the binary nodes' boxes inflated by EPS, as the TPU wrapper inflates
    its chunk boxes, so that the walk never culls a box whose triangle ties
    the best t, and flat boxes (a ground plane, a quad light) survive the
    strict slab test."""
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    escape = np.asarray(escape, np.int64)
    M = first.shape[0]
    leaf = count > 0
    if int(count.max()) >= 1 << COUNT_BITS:
        raise ValueError(f"a BVH leaf of {int(count.max())} triangles: the "
                         f"walk takes at most {(1 << COUNT_BITS) - 1}")
    if int((first + count).max()) >= 1 << (31 - COUNT_BITS):
        raise ValueError("too many triangles for the walk's leaf encoding")

    def split(c):
        """Binary node c itself if it is a leaf, else its two children."""
        inner = ~leaf[c]
        left = np.minimum(c + 1, M - 1)
        return np.where(inner, left, c), np.where(inner, escape[left], -1)

    levels = []
    frontier = np.zeros(0 if leaf[0] else 1, np.int64)
    if leaf[0]:                  # a tree of one leaf: a root with one child
        levels.append(np.array([[0, -1, -1, -1]], np.int64))
    while frontier.size:
        left = frontier + 1
        kids = np.stack([*split(left), *split(escape[left])], axis=1)
        levels.append(kids)
        flat = kids.ravel()
        frontier = flat[(flat >= 0) & ~leaf[flat]]
    kids = np.concatenate(levels)                        # [Mw, WIDTH]
    present = kids >= 0
    k = np.maximum(kids, 0)
    inner = present & ~leaf[k]
    # an interior child's wide index is its rank among all of them: each
    # level is the interior children of the one above, in this order
    wide = np.cumsum(inner.ravel()).reshape(kids.shape)
    child = np.where(inner, wide,
                     np.where(present, ~((first[k] << COUNT_BITS) | count[k]),
                              EMPTY)).astype(np.int32)
    eps = np.float32(EPS)
    lo = np.where(present[..., None],
                  np.asarray(bounds_min, np.float32)[k] - eps, np.float32(0))
    hi = np.where(present[..., None],
                  np.asarray(bounds_max, np.float32)[k] + eps, np.float32(0))
    rec = np.zeros((kids.shape[0], RECORD_WORDS), np.int32)
    boxes = np.concatenate([lo.transpose(0, 2, 1), hi.transpose(0, 2, 1)],
                           axis=1).astype(np.float32)    # [Mw, 6, WIDTH]
    rec[:, :6 * WIDTH] = boxes.reshape(-1, 6 * WIDTH).view(np.int32)
    rec[:, 6 * WIDTH:7 * WIDTH] = child
    return rec, len(levels)


def _prepare(geom: Geometry, accel: FlatBVH | None) -> _Prepared:
    """The kernel's inputs for a scene, cached on its geometry: the wide
    tree of the scene's BVH (or of a private one, whose tie-break positions
    stay the scene ids) and the triangle rows in slot order."""
    cached = getattr(geom, "_k4_prepared", None)
    if cached is not None and cached[0] is accel:
        return cached[1]
    dev = geom.v0.device
    if accel is None:
        v0, v1, v2 = (x.cpu().numpy() for x in geom.vertices())
        bvh = build_bvh_auto(v0, v1, v2)
        pos = bvh.perm.to(dev).contiguous()
    else:
        bvh = accel
        pos = None
    if bvh.perm.shape[0] != geom.num_triangles:
        raise ValueError(f"BVH over {bvh.perm.shape[0]} triangles, scene has "
                         f"{geom.num_triangles}")
    rec, depth = collapse_bvh(*(getattr(bvh, f).cpu().numpy() for f in (
        "bounds_min", "bounds_max", "first", "count", "escape")))
    if (WIDTH - 1) * depth > STACK_DEPTH:
        raise ValueError(f"a BVH of {depth} wide levels: the walk's stack "
                         f"holds {STACK_DEPTH // (WIDTH - 1)}")
    perm = bvh.perm.to(dev).contiguous()
    p = perm.long()
    zero = torch.zeros((p.shape[0], 1), dtype=torch.float32, device=dev)
    tris = torch.cat([geom.v0[p], zero, geom.e1[p], zero, geom.e2[p], zero],
                     dim=1)
    prep = _Prepared(nodes=torch.from_numpy(rec).to(dev),
                     tris=tris.contiguous(), pos=pos, perm=perm, depth=depth,
                     bvh_nodes=bvh.num_nodes, leaf_size=bvh.leaf_size)
    object.__setattr__(geom, "_k4_prepared", (accel, prep))
    return prep


def walk_plain(prep: _Prepared, ro, rd, t_lower, alive):
    """The kernel's walk over the kernel's layout in plain torch, every live
    lane one step at a time: the same records and rows, the same slab test,
    sorting network, stack, pruning and (t, position) fold. Returns the five
    outputs of the query and, per lane, the node records read and the
    triangles tested (i32[N] each; 0 on dead lanes)."""
    dev = ro.device
    N = ro.shape[0]
    boxes = prep.nodes[:, :6 * WIDTH].contiguous().view(torch.float32)
    boxes = boxes.reshape(-1, 6, WIDTH)
    kids = prep.nodes[:, 6 * WIDTH:7 * WIDTH]
    live = alive.nonzero()[:, 0]
    n = live.shape[0]
    o, d, tl = ro[live], rd[live], t_lower[live]
    inv = 1.0 / torch.where(d.abs() < TINY,
                            torch.where(d < 0, -TINY, TINY), d)
    inf = float("inf")
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    depth = max((WIDTH - 1) * prep.depth, 1)
    stack_key = torch.zeros((n, depth), **f32)
    stack_child = torch.zeros((n, depth), **i32)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = torch.zeros(n, **i32)                  # the root record
    best_t = torch.full((n,), BIG, **f32)
    best_u = torch.zeros(n, **f32)
    best_v = torch.zeros(n, **f32)
    best_pos = torch.full((n,), 0x7fffffff, **i32)
    best_slot = torch.zeros(n, **i32)
    n_nodes = torch.zeros(n, **i32)
    n_tris = torch.zeros(n, **i32)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    while bool(active.any()):
        at_leaf = active & (cur < 0)
        pop = at_leaf.clone()
        # ---- lanes at a node: four slab tests, nearest child next ----
        ix = (active & (cur >= 0)).nonzero()[:, 0]
        if ix.numel():
            c = cur[ix].long()
            box, kid = boxes[c], kids[c]
            oo, ii = o[ix][:, :, None], inv[ix][:, :, None]
            t1 = (box[:, 0:3] - oo) * ii
            t2 = (box[:, 3:6] - oo) * ii
            tn = torch.minimum(t1, t2).amax(dim=1)
            tf = torch.maximum(t1, t2).amin(dim=1)
            enter = ((kid != EMPTY) & (tn < tf) & (tf > 0.0)
                     & (tn <= best_t[ix][:, None]))
            key = list(torch.where(enter, tn, inf).unbind(1))
            child = list(kid.unbind(1))
            for a, b in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
                swap = key[b] < key[a]
                key[a], key[b] = (torch.where(swap, key[b], key[a]),
                                  torch.where(swap, key[a], key[b]))
                child[a], child[b] = (torch.where(swap, child[b], child[a]),
                                      torch.where(swap, child[a], child[b]))
            n_nodes[ix] += 1
            s = sp[ix]
            for j in (3, 2, 1):   # the farthest first
                push = key[j] < inf
                stack_key[ix[push], s[push]] = key[j][push]
                stack_child[ix[push], s[push]] = child[j][push]
                s = s + push.long()
            sp[ix] = s
            entered = key[0] < inf
            cur[ix] = torch.where(entered, child[0], cur[ix])
            pop[ix] = ~entered
        # ---- lanes at a leaf: its triangles in slot order ----
        ix = at_leaf.nonzero()[:, 0]
        if ix.numel():
            code = ~cur[ix]
            first = code >> COUNT_BITS
            count = code & ((1 << COUNT_BITS) - 1)
            n_tris[ix] += count
            for j in range(int(count.max())):
                m = j < count
                rows = ix[m]
                slot = first[m] + j
                tri = prep.tris[slot.long()]
                a, u_num, v_num, t_num = moller_trumbore(
                    *o[rows].unbind(1), *d[rows].unbind(1),
                    tri[:, 0], tri[:, 1], tri[:, 2], tri[:, 4], tri[:, 5],
                    tri[:, 6], tri[:, 8], tri[:, 9], tri[:, 10])
                t, u, v = (x[:, 0] for x in hit_tests(
                    a[:, None], u_num[:, None], v_num[:, None],
                    t_num[:, None], tl[rows]))
                p = slot if prep.pos is None else prep.pos[slot.long()]
                take = (t < BIG) & ((t < best_t[rows]) | (
                    (t == best_t[rows]) & (p < best_pos[rows])))
                rows = rows[take]
                best_t[rows] = t[take]
                best_u[rows] = u[take]
                best_v[rows] = v[take]
                best_pos[rows] = p[take]
                best_slot[rows] = slot[take]
        # ---- back to the nearest waiting entry that can still win ----
        while bool(pop.any()):
            ix = pop.nonzero()[:, 0]
            empty = sp[ix] == 0
            active[ix[empty]] = False
            pop[ix[empty]] = False
            ix = ix[~empty]
            sp[ix] -= 1
            ok = stack_key[ix, sp[ix]] <= best_t[ix]
            ix = ix[ok]
            cur[ix] = stack_child[ix, sp[ix]]
            pop[ix] = False

    hit_l = best_t < BIG
    out = [torch.zeros(N, dtype=torch.bool, device=dev), torch.zeros(N, **i32),
           torch.zeros(N, **f32), torch.zeros(N, **f32),
           torch.zeros(N, **f32), torch.zeros(N, **i32),
           torch.zeros(N, **i32)]
    out[0][live] = hit_l
    out[1][live] = torch.where(hit_l, prep.perm[best_slot.long()], 0)
    out[2][live] = torch.where(hit_l, best_t, 0.0)
    out[3][live] = torch.where(hit_l, best_u, 0.0)
    out[4][live] = torch.where(hit_l, best_v, 0.0)
    out[5][live] = n_nodes
    out[6][live] = n_tris
    return tuple(out)


def _launch(entry: str, geom, ro, rd, t_lower, alive, accel, n_counts: int):
    """Launch the kernel ``entry`` on CUDA tensors; returns its five outputs
    and ``n_counts`` per-lane i32 count tensors."""
    N = ro.shape[0]
    prep = _prepare(geom, accel)
    hit = torch.empty(N, dtype=torch.bool, device=ro.device)
    idx = torch.empty(N, dtype=torch.int32, device=ro.device)
    t = torch.empty(N, dtype=torch.float32, device=ro.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    counts = [torch.empty_like(idx) for _ in range(n_counts)]
    err = getattr(native.load(), entry)(
        ro.data_ptr(), rd.data_ptr(), t_lower.data_ptr(), alive.data_ptr(),
        prep.nodes.data_ptr(), prep.tris.data_ptr(),
        None if prep.pos is None else prep.pos.data_ptr(),
        prep.perm.data_ptr(), N, prep.nodes.shape[0], hit.data_ptr(),
        idx.data_ptr(), t.data_ptr(), u.data_ptr(), v.data_ptr(),
        *(c.data_ptr() for c in counts),
        torch.cuda.current_stream(ro.device).cuda_stream)
    native.check(err, entry)
    return (hit, idx, t, u, v, *counts)


def _defaults(ro, t_lower, alive):
    """No lower bound and every lane alive where the caller gave None."""
    N = ro.shape[0]
    if t_lower is None:
        t_lower = torch.zeros(N, dtype=torch.float32, device=ro.device)
    if alive is None:
        alive = torch.ones(N, dtype=torch.bool, device=ro.device)
    return t_lower, alive


def intersect_list(geom: Geometry, ro, rd, t_lower=None, alive=None,
                   accel: FlatBVH | None = None):
    """Closest-hit query through the BVH kernel (CUDA tensors) or its plain
    version (CPU tensors). ``accel`` is the scene's BVH or None."""
    t_lower, alive = _defaults(ro, t_lower, alive)
    check_query(geom, ro, rd, t_lower, alive)
    if ro.device.type == "cpu":
        return intersect_list_plain(geom, ro, rd, t_lower, alive,
                                    None if accel is None else accel.perm)
    if ro.device.type != "cuda":
        raise ValueError(f"no intersect kernel for device {ro.device}")
    out = _launch("pbr_intersect_bvh", geom, ro, rd, t_lower, alive, accel, 0)
    observability.count("intersect_list")
    if native.launch_records is not None:
        prep = _prepare(geom, accel)
        native.launch_records.append(("intersect_list", {
            "n": ro.shape[0], "alive": alive, "hit": out[0],
            "n_nodes": prep.bvh_nodes, "n_tris": geom.num_triangles,
            "leaf_size": prep.leaf_size}))
    return out


def intersect_list_stats(geom: Geometry, ro, rd, t_lower=None, alive=None,
                         accel: FlatBVH | None = None):
    """The kernel's counting twin, on CUDA tensors only: the query's five
    outputs and, per ray, the node records read and the triangles tested
    (i32[N] each). For measurement; no render path calls it."""
    t_lower, alive = _defaults(ro, t_lower, alive)
    check_query(geom, ro, rd, t_lower, alive)
    if ro.device.type != "cuda":
        raise ValueError(f"the counting kernel needs CUDA tensors, got "
                         f"{ro.device}")
    return _launch("pbr_intersect_bvh_stats", geom, ro, rd, t_lower, alive,
                   accel, 2)

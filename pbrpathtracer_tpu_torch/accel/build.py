"""BVH construction on the host and its flattened stackless layout, as
``pbrpathtracer_tpu.accel.build``.

The tree is flattened depth first with escape links: node i's subtree
occupies [i, escape[i]); a walk goes to i + 1 when the ray hits node i's
box and to escape[i] when it misses. Leaves hold up to ``leaf_size``
consecutive slots of ``perm``, the triangle order of the tree.

Layout (FlatBVH, tensors):
  bounds_min/max f32[M,3]
  first  i32[M]  -- leaf: first slot in ``perm``; interior: 0
  count  i32[M]  -- leaf: triangle count; interior: 0
  escape i32[M]  -- index of the first node NOT in this subtree
  perm   i32[T]  -- scene triangle id of each slot

``build_bvh`` is the numpy median-split builder of the JAX package, line
for line, so both packages give the same arrays for the same triangles.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    bounds_min: torch.Tensor   # f32[M,3]
    bounds_max: torch.Tensor   # f32[M,3]
    first: torch.Tensor        # i32[M]
    count: torch.Tensor        # i32[M]
    escape: torch.Tensor       # i32[M]
    perm: torch.Tensor         # i32[T]
    leaf_size: int = 8

    @property
    def num_nodes(self) -> int:
        return self.first.shape[0]

    def to(self, device) -> "FlatBVH":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "leaf_size"})


def from_arrays(bounds_min, bounds_max, first, count, escape, perm,
                leaf_size: int) -> FlatBVH:
    """A FlatBVH from host arrays, copied into f32 / i32 CPU tensors."""
    def t(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype))
    f32, i32 = np.float32, np.int32
    return FlatBVH(bounds_min=t(bounds_min, f32), bounds_max=t(bounds_max, f32),
                   first=t(first, i32), count=t(count, i32),
                   escape=t(escape, i32), perm=t(perm, i32),
                   leaf_size=leaf_size)


def build_bvh(v0, v1, v2, leaf_size: int = 8) -> FlatBVH:
    """Median-split BVH over triangles; returns the flattened layout."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tri_min + tri_max) * 0.5

    # nodes appended in depth-first order
    bounds_min, bounds_max, first, count, escape = [], [], [], [], []
    perm_out = []

    def new_node(bmin, bmax):
        bounds_min.append(bmin)
        bounds_max.append(bmax)
        first.append(0)
        count.append(0)
        escape.append(0)
        return len(first) - 1

    def build(ids):
        bmin = tri_min[ids].min(axis=0)
        bmax = tri_max[ids].max(axis=0)
        # degenerate extents get a 1e-5 thickness, as the JAX builder's
        bmax = np.where(bmax - bmin < 1e-5, bmin + 1e-5, bmax)
        node = new_node(bmin, bmax)
        if len(ids) <= leaf_size:
            first[node] = len(perm_out)
            count[node] = len(ids)
            perm_out.extend(ids.tolist())
        else:
            c = centroid[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            order = np.argsort(c[:, axis], kind="stable")
            half = len(ids) // 2
            build(ids[order[:half]])
            build(ids[order[half:]])
        escape[node] = len(first)
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(np.arange(T))
    finally:
        sys.setrecursionlimit(old_limit)

    return from_arrays(np.asarray(bounds_min, np.float32),
                       np.asarray(bounds_max, np.float32), first, count,
                       escape, perm_out, leaf_size)


def validate_bvh(bvh: FlatBVH, n_tris: int) -> None:
    """Structural invariants; raises AssertionError on a violation."""
    first = bvh.first.cpu().numpy()
    count = bvh.count.cpu().numpy()
    escape = bvh.escape.cpu().numpy()
    bmin = bvh.bounds_min.cpu().numpy()
    bmax = bvh.bounds_max.cpu().numpy()
    perm = bvh.perm.cpu().numpy()
    M = len(first)

    assert (bmax >= bmin).all(), "inverted bounds"
    assert sorted(perm.tolist()) == list(range(n_tris)), "perm not a permutation"
    # escape monotonicity and subtree containment
    for i in range(M):
        assert i < escape[i] <= M, f"bad escape at {i}"
        if count[i] == 0:          # interior: at least 2 nodes inside
            assert escape[i] > i + 1, f"empty interior {i}"
        else:
            assert escape[i] == i + 1, f"leaf {i} escape must be i+1"
    # every leaf range valid, and the leaves cover every slot once
    leaves = np.nonzero(count > 0)[0]
    covered = 0
    for i in leaves:
        assert first[i] + count[i] <= len(perm)
        covered += count[i]
    assert covered == n_tris

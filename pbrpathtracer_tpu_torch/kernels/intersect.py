"""Dense closest-hit query: the CUDA kernel ``csrc/intersect.cu`` and its
plain torch version.

Replaces ``pbrpathtracer_tpu/kernels/intersect_pallas.py`` (``_run``, the
dense route of ``intersect_pallas``). The contract is the same:
``intersect_dense(geom, ro, rd, t_lower, alive, perm=None)`` returns
(hit bool[N], idx i32[N], t f32[N], u f32[N], v f32[N]); a miss or a dead
lane is a clean miss (hit False, idx = t = u = v = 0); ties go to the lowest
triangle id (in ``perm`` order when a permutation is given).

Tensors on the CPU take the plain version; CUDA tensors launch the kernel.
What the kernel reads of the scene (the ``perm``-ordered triangle rows and
the chunk boxes) is built once per geometry and cached on it, and the kernel
writes the final outputs, so a query on the card is five ``torch.empty`` and
one launch. The wrapper refuses scenes of more than ``MAX_DENSE_CHUNKS`` chunks (2048
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


def _check_tensors(device, specs):
    for name, x, dtype, shape in specs:
        if x is None:
            continue
        if x.shape != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, rays on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_rays(ro, rd, t_lower, alive):
    """Shapes, types, devices and layout of a query's rays; ``t_lower`` and
    ``alive`` may be None."""
    N = ro.shape[0]
    _check_tensors(ro.device, (("ro", ro, torch.float32, (N, 3)),
                               ("rd", rd, torch.float32, (N, 3)),
                               ("t_lower", t_lower, torch.float32, (N,)),
                               ("alive", alive, torch.bool, (N,))))


def check_scene(geom, perm, device):
    """The same for the triangles and their order; ``perm`` may be None."""
    T = geom.num_triangles
    _check_tensors(device, (("perm", perm, torch.int32, (T,)),
                            ("geom.v0", geom.v0, torch.float32, (T, 3)),
                            ("geom.e1", geom.e1, torch.float32, (T, 3)),
                            ("geom.e2", geom.e2, torch.float32, (T, 3))))


def check_query(geom, ro, rd, t_lower, alive, perm=None):
    """Everything a closest-hit query reads."""
    check_rays(ro, rd, t_lower, alive)
    check_scene(geom, perm, ro.device)


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


@dataclasses.dataclass(frozen=True)
class _Prepared:
    """What the kernel reads of a scene, built once per (geometry, perm)."""

    tris: torch.Tensor    # f32[T, 9]: v0, e1, e2 of each row, in perm order
    boxes: torch.Tensor   # f32[n_chunks, 6]: lo - EPS, hi + EPS per chunk
    perm: torch.Tensor | None   # i32[T] contiguous: scene id of each row
    chunk: int


def _prepare(geom: Geometry, perm) -> _Prepared:
    """The kernel's inputs for a scene, cached on its geometry under the
    identity of ``perm``. A geometry made by ``dataclasses.replace`` or
    ``.to`` is another object and is prepared afresh; in-place edits of
    ``geom.v0/e1/e2`` (or of ``perm``) after a first query are not seen."""
    cached = getattr(geom, "_k1_prepared", None)
    if cached is not None and cached[0] is perm:
        return cached[1]
    check_scene(geom, perm, geom.v0.device)
    chunk, n_chunks = _chunking(geom.num_triangles)
    tris, boxes = _tris_and_boxes(*_permuted(geom, perm), chunk, n_chunks)
    prep = _Prepared(tris=tris, boxes=boxes, chunk=chunk, perm=perm)
    object.__setattr__(geom, "_k1_prepared", (perm, prep))
    return prep


def intersect_dense(geom: Geometry, ro, rd, t_lower=None, alive=None,
                    perm=None):
    """Closest-hit query through the dense kernel (CUDA tensors) or its
    plain version (CPU tensors). ``t_lower=None`` means no lower bound and
    ``alive=None`` all lanes alive; ``perm`` i32[T] orders the triangles
    (row r of the kernel is scene triangle ``perm[r]``). On the card the
    triangle rows are built at a geometry's first query and cached on it:
    change a scene with ``dataclasses.replace``, not in place."""
    N = ro.shape[0]
    if dense_chunks(geom.num_triangles) > MAX_DENSE_CHUNKS:
        raise NotImplementedError(
            f"{geom.num_triangles} triangles: the dense kernel takes at most "
            f"{MAX_DENSE_CHUNKS * MAX_CHUNK}; larger scenes take "
            "kernels.intersect_list.intersect_list")
    if ro.device.type == "cpu":
        check_query(geom, ro, rd, t_lower, alive, perm)
        if t_lower is None:
            t_lower = torch.zeros(N, dtype=torch.float32)
        if alive is None:
            alive = torch.ones(N, dtype=torch.bool)
        return intersect_dense_plain(geom, ro, rd, t_lower, alive, perm)
    if ro.device.type != "cuda":
        raise ValueError(f"no intersect kernel for device {ro.device}")

    # the scene is checked where its rows are built, once per geometry
    check_rays(ro, rd, t_lower, alive)
    prep = _prepare(geom, perm)
    if prep.tris.device != ro.device:
        raise ValueError(f"scene on {prep.tris.device}, rays on {ro.device}")
    hit = torch.empty(N, dtype=torch.bool, device=ro.device)
    idx = torch.empty(N, dtype=torch.int32, device=ro.device)
    t = torch.empty(N, dtype=torch.float32, device=ro.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)

    def ptr(x):
        return None if x is None else x.data_ptr()
    err = native.load().pbr_intersect_dense(
        ro.data_ptr(), rd.data_ptr(), ptr(t_lower), ptr(alive),
        prep.tris.data_ptr(), prep.boxes.data_ptr(), ptr(prep.perm), N,
        geom.num_triangles, prep.chunk, hit.data_ptr(), idx.data_ptr(),
        t.data_ptr(), u.data_ptr(), v.data_ptr(),
        torch.cuda.current_stream(ro.device).cuda_stream)
    native.check(err, "intersect_dense")
    intersect_dense.launches += 1
    return hit, idx, t, u, v


intersect_dense.launches = 0

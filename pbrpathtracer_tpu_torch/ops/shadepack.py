"""Packed per-triangle shading tables, as ``pbrpathtracer_tpu.ops.shadepack``.

Everything shading reads about a hit is folded into wide tables, so one row
fetch per lane serves it:

  * ``tri_pack`` f32[T, 55]: triangle attributes with the material row
    joined per triangle;
  * ``light_pack`` f32[L, 13]: light-triangle vertices, premultiplied
    emissive color and the scene triangle id;
  * the uv-opacity pack f32[T, 7] for the stochastic alpha re-trace.

Integer fields (mat_type, tex_index, light tri id) ride as exact floats
(below 2**24); readers convert them back with ``.long()`` / ``.to(int32)``.

``gather_fields`` fetches the rows with the pack-gather kernel
(``kernels/packgather.py``) as one field-major [W, N] block and hands out
per-field views of it (one ``split``). A field spec is checked once per
distinct spec and width; a bad one raises on every call. Without a graph
(grad off, or a table that needs none) that is all; with one, a single
``autograd.Function`` (``_GatherFields``) runs the same forward, and its
backward concatenates the field cotangents into the [W, N] block cotangent
(as the JAX package's ``_split_concat_vjp``) and hands it to the backward
kernel: autograd's own reverse of k views would build a zero [W, N] block
per field and add them.

The pack builders are plain torch around one more pack-gather: the tri
pack joins the material rows by ``mat_id`` with ``gather_rows_t`` from the
f32[M, 21] ``material_table``, so autograd carries the block's cotangent
through K3 and the table's ``cat`` to the ``Materials`` leaves. The light
pack indexes its few rows with torch; the uv-opacity pack's material column
is an integer field and carries no gradient.

A pack depends on the scene's leaves alone, so a sample builds each once
(``build_packs``, in ``ops.integrator.SamplePlan.prologue``) and hands it
to every segment; under a graph autograd sums the segments' cotangents of
a pack before its one backward. Nothing keeps a pack across samples: a
scene's leaves may change in place between two (a fit's update). Every
build counts one in the ``pack_builds`` counter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.packgather import (gather_rows_t, gather_rows_t_bwd,
                                  gather_rows_t_fwd)
from ..utils import observability
from ..utils.constants import TEX_OPACITY


def _width(s) -> int:
    return s.stop - s.start if isinstance(s, slice) else 1


def _field_plan(fields, width: int) -> tuple:
    """(the width of each field, whether each is an int field), after
    checking that the fields are ordered, disjoint and cover the table's
    ``width`` columns (the backward concatenates)."""
    start = 0
    for s in fields:
        if (s.start if isinstance(s, slice) else s) != start:
            raise ValueError("fields must be ordered, disjoint slices "
                             "covering the table's columns")
        start += _width(s)
    if start != width:
        raise ValueError(f"fields cover {start} of {width} columns")
    return (tuple(_width(s) for s in fields),
            tuple(not isinstance(s, slice) for s in fields))


_PLANS = {}   # (fields, width) -> _field_plan's result, good specs only


def _plan_of(fields, width: int) -> tuple:
    try:
        plan = _PLANS.get((fields, width))
    except TypeError:  # slices hash from Python 3.12 on
        return _field_plan(fields, width)
    if plan is None:
        plan = _PLANS[(fields, width)] = _field_plan(fields, width)
    return plan


def _split(rows, plan) -> tuple:
    """Views of the [W, N] block: [N, w] per slice field, [N] per int
    field."""
    widths, ints = plan
    return tuple(c.squeeze(1) if i else c
                 for c, i in zip(rows.T.split(widths, 1), ints))


class _GatherFields(torch.autograd.Function):
    """K2 forward and the views; the backward concatenates the field
    cotangents (zeros where a field got none) and runs K3. No gradient
    w.r.t. the ids."""

    @staticmethod
    def forward(ctx, table, idx, plan):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.ints = table.shape[0], plan[1]
        return _split(gather_rows_t_fwd(table, idx), plan)

    @staticmethod
    def backward(ctx, *cots):
        (idx,) = ctx.saved_tensors
        cot = torch.cat([c[None, :] if i else c.T
                         for c, i in zip(cots, ctx.ints)], dim=0)
        return gather_rows_t_bwd(idx, cot, ctx.n_rows), None, None


def gather_fields(table, idx, fields) -> tuple:
    """Per-lane attributes ``split(table[idx], fields)``: a slice field comes
    back as an [N, w] view, an int field as [N]. ``fields`` must be ordered,
    disjoint and cover the table's columns (the backward concatenates).
    Its forward's device time is the ``pbr.fetch`` span's."""
    plan = _plan_of(tuple(fields), table.shape[1])
    if torch.is_grad_enabled() and table.requires_grad:
        with observability.device_span("pbr.fetch", table.is_cuda):
            return _GatherFields.apply(table, idx, plan)
    return _split(gather_block(table, idx), plan)


def gather_block(table, idx):
    """The field-major f32[W, N] block of rows ``table[idx]`` that
    ``gather_fields`` splits, without a graph (the ``pbr.fetch`` span)."""
    with observability.device_span("pbr.fetch", table.is_cuda):
        return gather_rows_t_fwd(table, idx)


# ---- tri_pack column layout -------------------------------------------------
NORMAL = slice(0, 3)       # geometric normal
N0 = slice(3, 6)           # per-vertex shading normals
N1 = slice(6, 9)
N2 = slice(9, 12)
UV0 = slice(12, 14)
UV1 = slice(14, 16)
UV2 = slice(16, 18)
SMOOTH = 18                # smoothing-group flag, 0.0/1.0
DIFFUSE = slice(19, 22)    # material fields, joined via mat_id
SPECULAR = slice(22, 25)
EMISSIVE = slice(25, 28)
EMISS_INT = 28
ROUGHNESS = 29
REFLECTIVENESS = 30
TRANSLUCENCY = 31
IOR = 32
MAT_TYPE = 33              # 0.0 = OPAQUE, 1.0 = TRANSLUCENT
TEX_IDX = slice(34, 40)    # six texture-slot indices, -1.0 = none
TANGENT = slice(40, 43)
BITANGENT = slice(43, 46)
V0 = slice(46, 49)         # winner-triangle geometry
E1 = slice(49, 52)
E2 = slice(52, 55)
TRI_PACK_WIDTH = 55

TRI_FIELDS = (NORMAL, N0, N1, N2, UV0, UV1, UV2, SMOOTH,
              DIFFUSE, SPECULAR, EMISSIVE, EMISS_INT, ROUGHNESS,
              REFLECTIVENESS, TRANSLUCENCY, IOR, MAT_TYPE, TEX_IDX,
              TANGENT, BITANGENT, V0, E1, E2)

# ---- light_pack column layout ------------------------------------------------
L_V0 = slice(0, 3)
L_E1 = slice(3, 6)
L_E2 = slice(6, 9)
L_COLOR = slice(9, 12)     # emissive * emissive_intensity, premultiplied
L_TRI = 12                 # scene triangle index of the light
LIGHT_PACK_WIDTH = 13

LIGHT_FIELDS = (L_V0, L_E1, L_E2, L_COLOR, L_TRI)

# ---- uv-opacity pack column layout --------------------------------------------
UV_OPACITY_FIELDS = (slice(0, 2), slice(2, 4), slice(4, 6), 6)


def _col(x):
    return x.to(torch.float32)[:, None]


def build_tri_pack(scene) -> torch.Tensor:
    """f32[T, 55] joined triangle + material shading table (the
    ``pbr.pack`` span, as every pack build)."""
    g, m = scene.geom, scene.materials
    if g.num_triangles >= 2 ** 24 or m.num_materials >= 2 ** 24:
        raise ValueError("ids ride as float32 in the pack: need < 2**24")
    observability.count("pack_builds")
    with observability.device_span("pbr.pack", g.v0.is_cuda):
        return _tri_pack(g, m)


def material_table(m) -> torch.Tensor:
    """f32[M, 21]: the material fields in the tri pack's column order
    (``DIFFUSE`` .. ``TEX_IDX``), one row per material."""
    return torch.cat([
        m.diffuse, m.specular, m.emissive,
        _col(m.emissive_intensity), _col(m.roughness),
        _col(m.reflectiveness), _col(m.translucency),
        _col(m.ior), _col(m.mat_type),
        m.tex_index.to(torch.float32),
    ], dim=1)


def _tri_pack(g, m):
    # The material join is one row gather by mat_id through the pack-gather
    # pair: its backward is one K3 reduction onto the material table, which
    # the cat's backward splits onto the leaves.
    mat = gather_rows_t(material_table(m), g.mat_id).T
    return torch.cat([
        g.normal, g.n0, g.n1, g.n2,
        g.uv0, g.uv1, g.uv2,
        _col(g.smoothing),
        mat.contiguous(),
        g.tangent, g.bitangent,
        g.v0, g.e1, g.e2,
    ], dim=1)


def build_light_pack(scene) -> torch.Tensor:
    """f32[L, 13] light-sampling table."""
    g, m = scene.geom, scene.materials
    if g.num_triangles >= 2 ** 24:
        raise ValueError("light tri ids ride as float32: need < 2**24")
    observability.count("pack_builds")
    with observability.device_span("pbr.pack", g.v0.is_cuda):
        lt = scene.lights.long()
        lmid = g.mat_id[lt].long()
        lcolor = m.emissive[lmid] * m.emissive_intensity[lmid][:, None]
        return torch.cat([g.v0[lt], g.e1[lt], g.e2[lt], lcolor, _col(lt)],
                         dim=1)


def build_uv_opacity_pack(scene) -> torch.Tensor:
    """f32[T, 7] = (uv0, uv1, uv2, opacity texture index)."""
    g, m = scene.geom, scene.materials
    observability.count("pack_builds")
    with observability.device_span("pbr.pack", g.v0.is_cuda):
        otex = m.tex_index[g.mat_id.long(), TEX_OPACITY]
        return torch.cat([g.uv0, g.uv1, g.uv2, _col(otex)], dim=1)


class ScenePacks(NamedTuple):
    """The packs that a sample's segments read; None where the scene needs
    none."""

    tri: torch.Tensor
    light: torch.Tensor | None          # None without lights
    uv_opacity: torch.Tensor | None     # None without an opacity texture


def build_packs(scene) -> ScenePacks:
    """Every pack that a sample of ``scene`` reads, each built once."""
    return ScenePacks(
        build_tri_pack(scene),
        build_light_pack(scene) if scene.num_lights else None,
        build_uv_opacity_pack(scene) if scene.has_opacity_tex else None)

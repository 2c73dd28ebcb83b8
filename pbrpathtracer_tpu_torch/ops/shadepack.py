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
per-field views of it. Its backward is one concatenation of the field
cotangents into the [W, N] block cotangent (``_SplitFields``, as the JAX
package's ``_split_concat_vjp``): autograd's own reverse of k views would
build a zero [W, N] block per field and add them.

The pack builders are plain torch, so autograd carries the block's
cotangent on through the material join ``m.diffuse[mid]`` to the
``Materials`` leaves.
"""

from __future__ import annotations

import torch

from ..kernels.packgather import gather_rows_t
from ..utils.constants import TEX_OPACITY


def _width(s) -> int:
    return s.stop - s.start if isinstance(s, slice) else 1


class _SplitFields(torch.autograd.Function):
    """Views of a [W, N] block per field; the backward concatenates the
    field cotangents (zeros where a field got none)."""

    @staticmethod
    def forward(ctx, rows, fields):
        ctx.fields = fields
        return tuple(rows[s].T if isinstance(s, slice) else rows[s]
                     for s in fields)

    @staticmethod
    def backward(ctx, *cots):
        parts = [c.T if isinstance(s, slice) else c[None, :]
                 for s, c in zip(ctx.fields, cots)]
        return torch.cat(parts, dim=0), None


def gather_fields(table, idx, fields) -> tuple:
    """Per-lane attributes ``split(table[idx], fields)``: a slice field comes
    back as an [N, w] view, an int field as [N]. ``fields`` must be ordered,
    disjoint and cover the table's columns (the backward concatenates)."""
    fields = tuple(fields)
    start = 0
    for s in fields:
        if (s.start if isinstance(s, slice) else s) != start:
            raise ValueError("fields must be ordered, disjoint slices "
                             "covering the table's columns")
        start += _width(s)
    if start != table.shape[1]:
        raise ValueError(f"fields cover {start} of {table.shape[1]} columns")
    return _SplitFields.apply(gather_rows_t(table, idx), fields)


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
    """f32[T, 55] joined triangle + material shading table."""
    g, m = scene.geom, scene.materials
    if g.num_triangles >= 2 ** 24 or m.num_materials >= 2 ** 24:
        raise ValueError("ids ride as float32 in the pack: need < 2**24")
    mid = g.mat_id.long()
    return torch.cat([
        g.normal, g.n0, g.n1, g.n2,
        g.uv0, g.uv1, g.uv2,
        _col(g.smoothing),
        m.diffuse[mid], m.specular[mid], m.emissive[mid],
        _col(m.emissive_intensity[mid]), _col(m.roughness[mid]),
        _col(m.reflectiveness[mid]), _col(m.translucency[mid]),
        _col(m.ior[mid]), _col(m.mat_type[mid]),
        m.tex_index[mid].to(torch.float32),
        g.tangent, g.bitangent,
        g.v0, g.e1, g.e2,
    ], dim=1)


def build_light_pack(scene) -> torch.Tensor:
    """f32[L, 13] light-sampling table."""
    g, m = scene.geom, scene.materials
    if g.num_triangles >= 2 ** 24:
        raise ValueError("light tri ids ride as float32: need < 2**24")
    lt = scene.lights.long()
    lmid = g.mat_id[lt].long()
    lcolor = m.emissive[lmid] * m.emissive_intensity[lmid][:, None]
    return torch.cat([g.v0[lt], g.e1[lt], g.e2[lt], lcolor, _col(lt)], dim=1)


def build_uv_opacity_pack(scene) -> torch.Tensor:
    """f32[T, 7] = (uv0, uv1, uv2, opacity texture index)."""
    g, m = scene.geom, scene.materials
    otex = m.tex_index[g.mat_id.long(), TEX_OPACITY]
    return torch.cat([g.uv0, g.uv1, g.uv2, _col(otex)], dim=1)

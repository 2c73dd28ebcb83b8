"""Scene arrays of the ``cornell`` configuration: the Cornell box as the
program's ``scene.builders.cornell_box()`` builds it (36 triangles: walls,
an area light under the ceiling, two diffuse boxes), frozen here in numpy so
that the benchmark hands the same numbers to the program and to its
reference. ``build(spec, seed)`` returns ``tris`` (v0, v1, v2, uv0, uv1,
uv2, mat_id, element_id), ``materials`` (one dict of material fields each)
and ``textures`` (none)."""

import numpy as np

_QUAD_UV = [((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1))]
_MATERIAL = dict(mat_type=0, diffuse=(1.0, 1.0, 1.0), specular=(1.0, 1.0, 1.0),
                 emissive=(0.0, 0.0, 0.0), emissive_intensity=1.0,
                 roughness=1.0, reflectiveness=0.0, translucency=1.0, ior=1.5,
                 tex_index=(-1,) * 6)


def material(**kw):
    """A material dict with the renderer's defaults for the fields not
    given."""
    return {**_MATERIAL, **kw}


def quad(a, b, c, d):
    return [(a, b, c), (a, c, d)]


def box(center, size, rot_y=0.0):
    sx, sy, sz = size[0] / 2, size[1] / 2, size[2] / 2
    corners = np.array([
        [-sx, -sy, -sz], [sx, -sy, -sz], [sx, -sy, sz], [-sx, -sy, sz],
        [-sx, sy, -sz], [sx, sy, -sz], [sx, sy, sz], [-sx, sy, sz],
    ], np.float32)
    cs, sn = np.cos(rot_y), np.sin(rot_y)
    R = np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]], np.float32)
    corners = corners @ R.T + np.array(center, np.float32)
    c = [tuple(p) for p in corners]
    quads = [(c[3], c[2], c[1], c[0]), (c[4], c[5], c[6], c[7]),
             (c[0], c[1], c[5], c[4]), (c[2], c[3], c[7], c[6]),
             (c[3], c[0], c[4], c[7]), (c[1], c[2], c[6], c[5])]
    tris = []
    for q in quads:
        tris += quad(*q)
    return tris


def assemble(groups):
    """tris arrays of [(triangle list, material id)]."""
    v0, v1, v2, uv0, uv1, uv2, mat_id = [], [], [], [], [], [], []
    for tris, mid in groups:
        for k, (a, b, c) in enumerate(tris):
            v0.append(a)
            v1.append(b)
            v2.append(c)
            u = _QUAD_UV[k % 2]
            uv0.append(u[0])
            uv1.append(u[1])
            uv2.append(u[2])
            mat_id.append(mid)
    f32 = np.float32
    return {"v0": np.array(v0, f32), "v1": np.array(v1, f32),
            "v2": np.array(v2, f32), "uv0": np.array(uv0, f32),
            "uv1": np.array(uv1, f32), "uv2": np.array(uv2, f32),
            "mat_id": np.array(mat_id, np.int32),
            "element_id": np.array(mat_id, np.int32)}


def build(spec, seed):
    """The box; ``seed`` changes nothing in it."""
    white = (0.75, 0.75, 0.75)
    mats = [
        material(diffuse=white, specular=(0, 0, 0)),
        material(diffuse=(0.75, 0.25, 0.25), specular=(0, 0, 0)),
        material(diffuse=(0.25, 0.25, 0.75), specular=(0, 0, 0)),
        material(diffuse=(0.78, 0.78, 0.78), emissive=(1.0, 0.85, 0.6),
                 emissive_intensity=1.5, specular=(0, 0, 0)),
        material(diffuse=white, specular=(0, 0, 0)),
        material(diffuse=white, specular=(0, 0, 0)),
    ]
    e = 0.995
    groups = [
        (quad((-1, -1, 0), (-1, -1, 4), (1, -1, 4), (1, -1, 0)), 0),
        (quad((-1, 1, 0), (1, 1, 0), (1, 1, 4), (-1, 1, 4)), 0),
        (quad((-1, -1, 4), (-1, 1, 4), (1, 1, 4), (1, -1, 4)), 0),
        (quad((-1, -1, 0), (-1, 1, 0), (-1, 1, 4), (-1, -1, 4)), 1),
        (quad((1, -1, 0), (1, -1, 4), (1, 1, 4), (1, 1, 0)), 2),
        (quad((-0.4, e, 1.8), (0.4, e, 1.8), (0.4, e, 2.6), (-0.4, e, 2.6)),
         3),
        (box((-0.42, -0.4, 2.8), (0.6, 1.2, 0.6), rot_y=0.3), 4),
        (box((0.45, -0.7, 2.0), (0.6, 0.6, 0.6), rot_y=-0.25), 5),
    ]
    return {"tris": assemble(groups), "materials": mats, "textures": []}

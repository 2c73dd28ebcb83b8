"""Procedural scenes, built on the host with numpy exactly as the JAX
package's ``scene/builders.py`` builds them, so both packages render the same
triangles and materials. The machine that runs the port has no JAX, so the
port packs its own scenes; ``bridge.from_reference`` serves only the tests.

Every scene function here takes ``device`` and returns its scene there: on
the card (``"cuda"``) unless the caller names another, ``device="cpu"`` for
the CPU. The scene is assembled on the host and moved once at the end;
without a card the default raises torch's own error."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scene import (
    Geometry, MaterialSpec, Materials, Scene, finalize_scene, pack_geometry,
    pack_materials,
)
from ..utils.constants import TRANSLUCENT


def _quad(a, b, c, d):
    """Two CCW triangles for quad a-b-c-d (normal by the right-hand rule)."""
    return [(a, b, c), (a, c, d)]


_QUAD_UV = [((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1))]


def _box(center, size, rot_y=0.0):
    """12 triangles of an axis-aligned box rotated rot_y radians about Y."""
    sx, sy, sz = size[0] / 2, size[1] / 2, size[2] / 2
    corners = np.array([
        [-sx, -sy, -sz], [sx, -sy, -sz], [sx, -sy, sz], [-sx, -sy, sz],
        [-sx, sy, -sz], [sx, sy, -sz], [sx, sy, sz], [-sx, sy, sz],
    ], np.float32)
    cs, sn = np.cos(rot_y), np.sin(rot_y)
    R = np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]], np.float32)
    corners = corners @ R.T + np.array(center, np.float32)
    c = [tuple(p) for p in corners]
    quads = [
        (c[3], c[2], c[1], c[0]),  # bottom (faces -y)
        (c[4], c[5], c[6], c[7]),  # top
        (c[0], c[1], c[5], c[4]),  # front (-z side)
        (c[2], c[3], c[7], c[6]),  # back
        (c[3], c[0], c[4], c[7]),  # left
        (c[1], c[2], c[6], c[5]),  # right
    ]
    tris = []
    for q in quads:
        tris += _quad(*q)
    return tris


def _assemble_geom(tri_groups) -> Geometry:
    """tri_groups: list of (tri_list, mat_id)."""
    v0, v1, v2, uv0, uv1, uv2, mat_id = [], [], [], [], [], [], []
    for tris, mid in tri_groups:
        for k, (a, b, c) in enumerate(tris):
            v0.append(a)
            v1.append(b)
            v2.append(c)
            u = _QUAD_UV[k % 2]
            uv0.append(u[0])
            uv1.append(u[1])
            uv2.append(u[2])
            mat_id.append(mid)
    return pack_geometry({
        "v0": np.array(v0, np.float32),
        "v1": np.array(v1, np.float32),
        "v2": np.array(v2, np.float32),
        "uv0": np.array(uv0, np.float32),
        "uv1": np.array(uv1, np.float32),
        "uv2": np.array(uv2, np.float32),
        "mat_id": np.array(mat_id, np.int32),
        "element_id": np.array(mat_id, np.int32),
    })


def _assemble(tri_groups, materials, device) -> Scene:
    return finalize_scene(_assemble_geom(tri_groups),
                          pack_materials(materials)).to(device)


def cornell_box(with_boxes: bool = True,
                left_diffuse=(0.75, 0.25, 0.25),
                right_diffuse=(0.25, 0.25, 0.75),
                white=(0.75, 0.75, 0.75),
                light_emissive=(1.0, 0.85, 0.6),
                light_intensity: float = 1.5,
                device: str | torch.device = "cuda") -> Scene:
    """Cornell box, camera looking down +z: room x,y in [-1, 1], z in [0, 4],
    an area light under the ceiling and two diffuse boxes (36 triangles).
    Walls wind inward, so NEE's ``dot(n, l) <= 0`` rejection sees the
    classic setup."""
    mats = [
        MaterialSpec(diffuse=white, specular=(0, 0, 0)),            # 0 white walls
        MaterialSpec(diffuse=left_diffuse, specular=(0, 0, 0)),     # 1 left (red)
        MaterialSpec(diffuse=right_diffuse, specular=(0, 0, 0)),    # 2 right (blue)
        MaterialSpec(diffuse=(0.78, 0.78, 0.78),
                     emissive=light_emissive,
                     emissive_intensity=light_intensity,
                     specular=(0, 0, 0)),                           # 3 light
        MaterialSpec(diffuse=white, specular=(0, 0, 0)),            # 4 tall box
        MaterialSpec(diffuse=white, specular=(0, 0, 0)),            # 5 short box
    ]
    groups = []
    # floor y=-1 (normal +y)
    groups.append((_quad((-1, -1, 0), (-1, -1, 4), (1, -1, 4), (1, -1, 0)), 0))
    # ceiling y=+1 (normal -y)
    groups.append((_quad((-1, 1, 0), (1, 1, 0), (1, 1, 4), (-1, 1, 4)), 0))
    # back wall z=4 (normal -z)
    groups.append((_quad((-1, -1, 4), (-1, 1, 4), (1, 1, 4), (1, -1, 4)), 0))
    # left wall x=-1 (normal +x)
    groups.append((_quad((-1, -1, 0), (-1, 1, 0), (-1, 1, 4), (-1, -1, 4)), 1))
    # right wall x=+1 (normal -x)
    groups.append((_quad((1, -1, 0), (1, -1, 4), (1, 1, 4), (1, 1, 0)), 2))
    # ceiling light (slightly below the ceiling, normal -y)
    e = 0.995
    groups.append((_quad((-0.4, e, 1.8), (0.4, e, 1.8), (0.4, e, 2.6), (-0.4, e, 2.6)), 3))
    if with_boxes:
        groups.append((_box((-0.42, -0.4, 2.8), (0.6, 1.2, 0.6), rot_y=0.3), 4))
        groups.append((_box((0.45, -0.7, 2.0), (0.6, 0.6, 0.6), rot_y=-0.25), 5))
    return _assemble(groups, mats, device)


def cornell_spheres_scene(n_seg: int = 12,
                          device: str | torch.device = "cuda") -> Scene:
    """Cornell box with a glossy and a rough-metal faceted sphere
    (588 triangles: two chunks of the dense intersector)."""
    scene = cornell_box(with_boxes=False, device="cpu")
    mats = [
        MaterialSpec(diffuse=(0.9, 0.7, 0.3), specular=(0.95, 0.85, 0.6),
                     roughness=0.3, reflectiveness=0.9),
        MaterialSpec(diffuse=(0.7, 0.7, 0.8), specular=(0.9, 0.9, 0.95),
                     roughness=1.0, reflectiveness=1.0),
    ]

    def sphere_tris(center, radius):
        tris = []
        for i in range(n_seg):
            for j in range(n_seg):
                th0, th1 = np.pi * i / n_seg, np.pi * (i + 1) / n_seg
                ph0, ph1 = 2 * np.pi * j / n_seg, 2 * np.pi * (j + 1) / n_seg

                def pt(th, ph):
                    return (center[0] + radius * np.sin(th) * np.cos(ph),
                            center[1] + radius * np.cos(th),
                            center[2] + radius * np.sin(th) * np.sin(ph))
                a, b, c, d = pt(th0, ph0), pt(th1, ph0), pt(th1, ph1), pt(th0, ph1)
                tris.append((a, b, c))
                tris.append((a, c, d))
        return tris

    extra = [(sphere_tris((-0.45, -0.6, 2.6), 0.4), 6),
             (sphere_tris((0.5, -0.65, 1.9), 0.35), 7)]
    return _merge_into(scene, extra, mats).to(device)


def translucent_scene(device: str | torch.device = "cuda") -> Scene:
    """Cornell box around a dielectric (glass-like) box."""
    scene = cornell_box(with_boxes=False, device="cpu")
    mats = [MaterialSpec(mat_type=TRANSLUCENT, diffuse=(0.95, 0.95, 0.99),
                         specular=(1, 1, 1), roughness=0.0,
                         reflectiveness=0.0, translucency=1.0, ior=1.5)]
    extra = [(_box((0.0, -0.45, 2.2), (0.8, 1.1, 0.5), rot_y=0.4), 6)]
    return _merge_into(scene, extra, mats).to(device)


def mirror_box_scene(spec_level: float = 0.9,
                     diffuse_level: float = 0.9,
                     device: str | torch.device = "cuda") -> Scene:
    """A closed box of perfect mirrors (reflectiveness 1, roughness 0) with a
    ceiling light: specular chains here are bounded only by Russian roulette
    and the segment cap."""
    s = spec_level
    d = diffuse_level
    mats = [
        MaterialSpec(diffuse=(d, d, d), specular=(s, s, s),
                     roughness=0.0, reflectiveness=1.0),   # 0 mirror walls
        MaterialSpec(diffuse=(0.78, 0.78, 0.78), emissive=(1.0, 0.9, 0.7),
                     emissive_intensity=1.5, specular=(0, 0, 0)),  # 1 light
    ]
    groups = []
    groups.append((_quad((-1, -1, 0), (-1, -1, 4), (1, -1, 4), (1, -1, 0)), 0))
    groups.append((_quad((-1, 1, 0), (1, 1, 0), (1, 1, 4), (-1, 1, 4)), 0))
    groups.append((_quad((-1, -1, 4), (-1, 1, 4), (1, 1, 4), (1, -1, 4)), 0))
    groups.append((_quad((-1, -1, 0), (-1, 1, 0), (-1, 1, 4), (-1, -1, 4)), 0))
    groups.append((_quad((1, -1, 0), (1, -1, 4), (1, 1, 4), (1, 1, 0)), 0))
    # front wall z=0 closes the box behind the camera
    groups.append((_quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)), 0))
    e = 0.995
    groups.append((_quad((-0.4, e, 1.8), (0.4, e, 1.8), (0.4, e, 2.6),
                         (-0.4, e, 2.6)), 1))
    return _assemble(groups, mats, device)


def _merge_into(scene: Scene, tri_groups, new_materials) -> Scene:
    """Append triangle groups and materials to an existing host scene. The
    groups name absolute ids in the merged material table."""
    base_m = scene.materials
    add_m = pack_materials(new_materials)
    materials = Materials(**{
        f.name: torch.cat([getattr(base_m, f.name), getattr(add_m, f.name)])
        for f in dataclasses.fields(Materials)})
    g = _assemble_geom(tri_groups)
    geom = Geometry(**{
        f.name: torch.cat([getattr(scene.geom, f.name), getattr(g, f.name)])
        for f in dataclasses.fields(Geometry)})
    return finalize_scene(geom, materials, scene.textures)

"""Large procedural scenes of the BASELINE ladder (configs 3 and 5), as
``pbrpathtracer_tpu.scene.big_scenes``: numpy geometry ending in port
tensors, equal to the JAX package's scenes leaf for leaf (BVH included), so
the card runs the same scenes without JAX.

  mesh_scene(n_tris)     -- displaced terrain + a field of rocks under an
                            area light; ~n_tris triangles, checker/noise
                            textures on the terrain (config 3 at 50k)
  million_tri_scene()    -- config 5 geometry (~1M triangles)

Both take ``device`` and return the scene, BVH included, there: on the card
(``"cuda"``) unless the caller names another, ``device="cpu"`` for the CPU.
The scene is built on the host and moved once at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from .scene import (Camera, MaterialSpec, Scene, Textures, finalize_scene,
                    pack_geometry, pack_materials)


def _terrain(nx, nz, extent=8.0, height=1.2, seed=0):
    """Displaced grid: 2*(nx-1)*(nz-1) triangles with UVs."""
    rs = np.random.RandomState(seed)
    xs = np.linspace(-extent, extent, nx, dtype=np.float32)
    zs = np.linspace(0.5, 0.5 + 2 * extent, nz, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    # a few octaves of sines + noise
    Y = (np.sin(X * 0.7) * np.cos(Z * 0.5) * 0.5
         + np.sin(X * 2.3 + 1.7) * np.sin(Z * 1.9) * 0.25
         + rs.uniform(-0.05, 0.05, X.shape)).astype(np.float32) * height - 1.5

    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
    uvs = np.stack([(X.ravel() + extent) / (2 * extent),
                    (Z.ravel() - 0.5) / (2 * extent)], axis=-1)
    # quads (i, k) in row-major order, two triangles each: (a, b, c), (a, c, d)
    i, k = np.meshgrid(np.arange(nx - 1), np.arange(nz - 1), indexing="ij")
    a = (i * nz + k).ravel()
    b = ((i + 1) * nz + k).ravel()
    c = ((i + 1) * nz + k + 1).ravel()
    d = (i * nz + k + 1).ravel()
    idx = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)],
                   axis=1).reshape(-1, 3).astype(np.int32)
    return verts, uvs, idx


def _icosphere_tris(center, radius, n_seg=6):
    out = []
    for i in range(n_seg):
        for j in range(n_seg):
            th0, th1 = np.pi * i / n_seg, np.pi * (i + 1) / n_seg
            ph0, ph1 = 2 * np.pi * j / n_seg, 2 * np.pi * (j + 1) / n_seg

            def pt(th, ph):
                return (center[0] + radius * np.sin(th) * np.cos(ph),
                        center[1] + radius * np.cos(th),
                        center[2] + radius * np.sin(th) * np.sin(ph))
            a, b, c, d = pt(th0, ph0), pt(th1, ph0), pt(th1, ph1), pt(th0, ph1)
            out.append((a, b, c))
            out.append((a, c, d))
    return out


def _textures(tex_size: int = 64) -> Textures:
    """Checker diffuse + noise roughness stack; ``tex_size`` scales the
    checker."""
    rs = np.random.RandomState(7)
    cell = max(tex_size // 8, 1)
    ii, jj = np.meshgrid(np.arange(tex_size), np.arange(tex_size),
                         indexing="ij")
    c = np.where(((ii // cell) + (jj // cell)) % 2 == 0, 0.8, 0.35)
    checker = np.stack([c, c * 0.9, c * 0.7, np.ones_like(c)],
                       axis=-1).astype(np.float32)
    rough = np.zeros((32, 32, 4), np.float32)
    rough[..., 0] = rs.uniform(0.4, 1.0, (32, 32))
    images = [checker, rough]
    ph = max(im.shape[0] for im in images)
    pw = max(im.shape[1] for im in images)
    data = np.zeros((len(images), ph, pw, 4), np.float32)
    size = np.zeros((len(images), 2), np.int32)
    for k, im in enumerate(images):
        data[k, :im.shape[0], :im.shape[1]] = im
        size[k] = (im.shape[1], im.shape[0])
    return Textures(data=torch.from_numpy(data), size=torch.from_numpy(size))


def mesh_scene(n_tris: int = 50_000, textured: bool = True,
               accel: str = "auto", seed: int = 0,
               tex_size: int = 64,
               device: str | torch.device = "cuda") -> Scene:
    """~n_tris scene: textured displaced terrain + rock field + area light."""
    rs = np.random.RandomState(seed)

    # budget: ~70% terrain, ~28% rocks, the light fixed
    terrain_budget = max(int(n_tris * 0.7), 128)
    g = max(int(np.sqrt(terrain_budget / 2)) + 1, 4)
    verts, uvs, idx = _terrain(g, g, seed=seed)

    v0 = verts[idx[:, 0]]
    v1 = verts[idx[:, 1]]
    v2 = verts[idx[:, 2]]
    t0 = uvs[idx[:, 0]]
    t1 = uvs[idx[:, 1]]
    t2 = uvs[idx[:, 2]]
    mat_id = np.zeros(len(idx), np.int32)

    # rocks (spheres), material 1
    rock_budget = max(n_tris - len(idx) - 2 - 10, 0)
    per_rock = 2 * 6 * 6
    n_rocks = max(rock_budget // per_rock, 1)
    rv = []
    for _ in range(n_rocks):
        cx = rs.uniform(-7, 7)
        cz = rs.uniform(1.5, 15.0)
        cy = rs.uniform(-1.3, -0.4)
        rad = rs.uniform(0.15, 0.5)
        rv += _icosphere_tris((cx, cy, cz), rad)
    rvv = np.asarray(rv, np.float32)
    z2 = np.zeros((len(rvv), 2), np.float32)
    v0 = np.concatenate([v0, rvv[:, 0]])
    v1 = np.concatenate([v1, rvv[:, 1]])
    v2 = np.concatenate([v2, rvv[:, 2]])
    t0 = np.concatenate([t0, z2])
    t1 = np.concatenate([t1, z2])
    t2 = np.concatenate([t2, z2])
    mat_id = np.concatenate([mat_id, np.full(len(rvv), 1, np.int32)])

    # area light overhead, material 2
    ly = 4.0
    lv = np.asarray([((-2, ly, 5), (2, ly, 5), (2, ly, 9)),
                     ((-2, ly, 5), (2, ly, 9), (-2, ly, 9))], np.float32)
    z2 = np.zeros((2, 2), np.float32)
    v0 = np.concatenate([v0, lv[:, 0]])
    v1 = np.concatenate([v1, lv[:, 1]])
    v2 = np.concatenate([v2, lv[:, 2]])
    t0 = np.concatenate([t0, z2])
    t1 = np.concatenate([t1, z2])
    t2 = np.concatenate([t2, z2])
    mat_id = np.concatenate([mat_id, np.full(2, 2, np.int32)])

    mats = [
        MaterialSpec(diffuse=(0.65, 0.6, 0.5), specular=(0, 0, 0),
                     tex_index=((0 if textured else -1), -1, -1,
                                (1 if textured else -1), -1, -1)),
        MaterialSpec(diffuse=(0.4, 0.42, 0.45), specular=(0.6, 0.6, 0.65),
                     roughness=0.4, reflectiveness=0.35),
        MaterialSpec(diffuse=(0.9, 0.9, 0.9), emissive=(1.0, 0.95, 0.85),
                     emissive_intensity=2.0, specular=(0, 0, 0)),
    ]
    geom = pack_geometry({
        "v0": v0, "v1": v1, "v2": v2,
        "uv0": t0, "uv1": t1, "uv2": t2,
        "mat_id": mat_id, "element_id": mat_id,
    })
    textures = _textures(tex_size) if textured else None
    return finalize_scene(geom, pack_materials(mats), textures,
                          accel=accel).to(device)


def mesh_scene_camera() -> Camera:
    return Camera.make(pos=(0.2, 0.6, -1.5), dir=(0.0, -0.12, 1.0),
                       up=(0, 1, 0), fovy=55)


def million_tri_scene(accel: str = "auto",
                      device: str | torch.device = "cuda") -> Scene:
    """BASELINE config 5 geometry (~1M triangles)."""
    return mesh_scene(1_000_000, textured=True, accel=accel, device=device)

"""Scene arrays of the ``mesh50k`` configuration: BASELINE config 3, the
program's ``scene.big_scenes.mesh_scene(50_000)`` (displaced terrain with a
checker diffuse and a noise roughness texture, a field of specular rocks,
an area light; 49,970 triangles), frozen here in numpy so that the
benchmark hands the same numbers to the program and to its reference. The
run's seed is the mesh's own seed (terrain noise and rock placement).
``build(spec, seed)`` returns ``tris``, ``materials`` and ``textures``."""

import numpy as np

_MATERIAL = dict(mat_type=0, diffuse=(1.0, 1.0, 1.0), specular=(1.0, 1.0, 1.0),
                 emissive=(0.0, 0.0, 0.0), emissive_intensity=1.0,
                 roughness=1.0, reflectiveness=0.0, translucency=1.0, ior=1.5,
                 tex_index=(-1,) * 6)


def material(**kw):
    return {**_MATERIAL, **kw}


def _terrain(nx, nz, extent=8.0, height=1.2, seed=0):
    rs = np.random.RandomState(seed)
    xs = np.linspace(-extent, extent, nx, dtype=np.float32)
    zs = np.linspace(0.5, 0.5 + 2 * extent, nz, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = (np.sin(X * 0.7) * np.cos(Z * 0.5) * 0.5
         + np.sin(X * 2.3 + 1.7) * np.sin(Z * 1.9) * 0.25
         + rs.uniform(-0.05, 0.05, X.shape)).astype(np.float32) * height - 1.5
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
    uvs = np.stack([(X.ravel() + extent) / (2 * extent),
                    (Z.ravel() - 0.5) / (2 * extent)], axis=-1)
    i, k = np.meshgrid(np.arange(nx - 1), np.arange(nz - 1), indexing="ij")
    a = (i * nz + k).ravel()
    b = ((i + 1) * nz + k).ravel()
    c = ((i + 1) * nz + k + 1).ravel()
    d = (i * nz + k + 1).ravel()
    idx = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)],
                   axis=1).reshape(-1, 3).astype(np.int32)
    return verts, uvs, idx


def _sphere(center, radius, n_seg=6):
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


def _textures(tex_size):
    rs = np.random.RandomState(7)
    cell = max(tex_size // 8, 1)
    ii, jj = np.meshgrid(np.arange(tex_size), np.arange(tex_size),
                         indexing="ij")
    c = np.where(((ii // cell) + (jj // cell)) % 2 == 0, 0.8, 0.35)
    checker = np.stack([c, c * 0.9, c * 0.7, np.ones_like(c)],
                       axis=-1).astype(np.float32)
    rough = np.zeros((32, 32, 4), np.float32)
    rough[..., 0] = rs.uniform(0.4, 1.0, (32, 32))
    return [checker, rough]


def build(spec, seed):
    n_tris, tex_size = spec["n_tris"], spec["tex_size"]
    seed = int(seed) % 2 ** 32
    rs = np.random.RandomState(seed)
    g = max(int(np.sqrt(max(int(n_tris * 0.7), 128) / 2)) + 1, 4)
    verts, uvs, idx = _terrain(g, g, seed=seed)
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    t0, t1, t2 = uvs[idx[:, 0]], uvs[idx[:, 1]], uvs[idx[:, 2]]
    mat_id = np.zeros(len(idx), np.int32)
    n_rocks = max(max(n_tris - len(idx) - 2 - 10, 0) // (2 * 6 * 6), 1)
    rv = []
    for _ in range(n_rocks):
        cx = rs.uniform(-7, 7)
        cz = rs.uniform(1.5, 15.0)
        cy = rs.uniform(-1.3, -0.4)
        rad = rs.uniform(0.15, 0.5)
        rv += _sphere((cx, cy, cz), rad)
    rvv = np.asarray(rv, np.float32)
    ly = 4.0
    lv = np.asarray([((-2, ly, 5), (2, ly, 5), (2, ly, 9)),
                     ((-2, ly, 5), (2, ly, 9), (-2, ly, 9))], np.float32)
    z_r = np.zeros((len(rvv), 2), np.float32)
    z_l = np.zeros((2, 2), np.float32)
    mat_id = np.concatenate([mat_id, np.full(len(rvv), 1, np.int32),
                             np.full(2, 2, np.int32)])
    tris = {"v0": np.concatenate([v0, rvv[:, 0], lv[:, 0]]),
            "v1": np.concatenate([v1, rvv[:, 1], lv[:, 1]]),
            "v2": np.concatenate([v2, rvv[:, 2], lv[:, 2]]),
            "uv0": np.concatenate([t0, z_r, z_l]),
            "uv1": np.concatenate([t1, z_r, z_l]),
            "uv2": np.concatenate([t2, z_r, z_l]),
            "mat_id": mat_id, "element_id": mat_id}
    mats = [
        material(diffuse=(0.65, 0.6, 0.5), specular=(0, 0, 0),
                 tex_index=(0, -1, -1, 1, -1, -1)),
        material(diffuse=(0.4, 0.42, 0.45), specular=(0.6, 0.6, 0.65),
                 roughness=0.4, reflectiveness=0.35),
        material(diffuse=(0.9, 0.9, 0.9), emissive=(1.0, 0.95, 0.85),
                 emissive_intensity=2.0, specular=(0, 0, 0)),
    ]
    return {"tris": tris, "materials": mats, "textures": _textures(tex_size)}

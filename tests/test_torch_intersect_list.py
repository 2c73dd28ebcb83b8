"""The plain version of the port's BVH closest-hit kernel (K4: the route CPU
tensors take for scenes over 2048 triangles, and the version the CUDA kernel
is held against on the card) against the JAX package's candidate-list kernel
(``intersect_pallas`` in interpret mode, the list route), on the cases of
tests/test_pallas_list.py: mesh_scene(3000) without and with a BVH, the flat
37x37 plane, the t_lower re-trace, parallel slab rays, and 20% dead lanes.

Criterion, as tests/test_torch_intersect.py: hit and idx identical on
>= 99.9% of lanes, |dt|, |du|, |dv| <= 1e-5 where the winners agree, dead
lanes a clean miss. Measured on these inputs: winners agree on 100% of lanes
in every case, with |dt, du, dv| <= 2.1e-6 (XLA's CPU compiler contracts
the JAX arithmetic, so the values are not bit-equal to the port's op-by-op
ones).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrpathtracer_tpu.scene.big_scenes import mesh_scene as j_mesh_scene
from pbrpathtracer_tpu.scene.scene import (MaterialSpec, finalize_scene,
                                           pack_geometry, pack_materials)
from pbrpathtracer_tpu_torch.bridge import from_reference
from pbrpathtracer_tpu_torch.kernels import intersect_list as KL
from pbrpathtracer_tpu_torch.ops.hit import default_intersector


def _flat_plane_scene(n_side, y=0.0, extent=4.0, extra_quads=()):
    """Exactly coplanar tessellated plane (+ optional flat quads above it),
    without a BVH: tests/test_pallas_list.py's scene."""
    xs = np.linspace(-extent, extent, n_side + 1, dtype=np.float32)
    v0, v1, v2 = [], [], []
    for i in range(n_side):
        for k in range(n_side):
            a = (xs[i], y, xs[k])
            b = (xs[i + 1], y, xs[k])
            c = (xs[i + 1], y, xs[k + 1])
            d = (xs[i], y, xs[k + 1])
            v0 += [a, a]
            v1 += [b, c]
            v2 += [c, d]
    for (qy, qe) in extra_quads:
        a, b, c, d = ((-qe, qy, -qe), (qe, qy, -qe), (qe, qy, qe),
                      (-qe, qy, qe))
        v0 += [a, a]
        v1 += [b, c]
        v2 += [c, d]
    T = len(v0)
    z2 = np.zeros((T, 2), np.float32)
    geom = pack_geometry({
        "v0": np.asarray(v0, np.float32), "v1": np.asarray(v1, np.float32),
        "v2": np.asarray(v2, np.float32), "uv0": z2, "uv1": z2, "uv2": z2,
        "mat_id": np.zeros(T, np.int32), "element_id": np.zeros(T, np.int32),
    })
    return finalize_scene(geom, pack_materials([MaterialSpec()]), None,
                          accel="none")


def _rays(n, seed=0, origin_box=((-2, 1.0, -2), (2, 3.0, 2))):
    rs = np.random.RandomState(seed)
    lo, hi = np.asarray(origin_box[0]), np.asarray(origin_box[1])
    ro = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 2.0  # steep: stay inside the extent
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ro, d


def _jax_list(js, ro, rd, t_lower, alive):
    from jax.experimental.pallas import tpu as pltpu
    from pbrpathtracer_tpu.kernels import intersect_pallas as K
    T = js.num_triangles
    assert K.LIST_KERNEL_MIN_CHUNKS * K.MAX_CHUNK < T  # the list route
    with pltpu.force_tpu_interpret_mode():
        out = K.intersect_pallas(js, jnp.asarray(ro), jnp.asarray(rd),
                                 jnp.asarray(t_lower),
                                 alive=jnp.asarray(alive))
    return [np.asarray(x) for x in out]


def _port(ps, ro, rd, t_lower, alive):
    before = KL.intersect_list_plain.launches
    out = default_intersector(ps, torch.tensor(ro), torch.tensor(rd),
                              torch.tensor(t_lower), torch.tensor(alive))
    assert KL.intersect_list_plain.launches == before + 1
    return [x.numpy() for x in out]


def _check(js, ro, rd, t_lower=None, alive=None, min_hit_frac=0.4):
    n = ro.shape[0]
    t_lower = np.zeros(n, np.float32) if t_lower is None else t_lower
    alive = np.ones(n, bool) if alive is None else alive
    ps, _ = from_reference(js)
    rh, ri, rt, ru, rv = _jax_list(js, ro, rd, t_lower, alive)
    ph, pi, pt, pu, pv = _port(ps, ro, rd, t_lower, alive)
    same = (rh == ph) & (ri == pi)
    assert same.mean() >= 0.999, f"winners agree on {same.mean():.4%}"
    assert ph.mean() >= min_hit_frac * alive.mean()
    both = same & ph
    for a, b in ((rt, pt), (ru, pu), (rv, pv)):
        assert np.abs(a[both] - b[both]).max(initial=0.0) <= 1e-5
    assert ((pi == 0) & (pt == 0) & (pu == 0) & (pv == 0))[~ph].all()
    assert not ph[~alive].any()
    return ph, pt


@pytest.mark.parametrize("accel", ["auto", "always"])
def test_mesh_scene_matches_list_kernel(accel):
    js = j_mesh_scene(3000, textured=False, accel=accel)
    assert (js.accel is None) == (accel == "auto")
    ro, rd = _rays(512, seed=1, origin_box=((-4, 0.5, 1.0), (4, 2.5, 12.0)))
    _check(js, ro, rd)


def test_flat_plane_is_not_culled():
    js = _flat_plane_scene(37)  # 2738 triangles, every box flat in y
    ro, rd = _rays(384, seed=2)
    ph, _ = _check(js, ro, rd, min_hit_frac=0.9)
    assert ph.mean() > 0.9


def test_t_lower_retrace():
    js = _flat_plane_scene(37, extra_quads=((1.0, 4.0),))
    n = 256
    ro = (np.tile(np.array([[0.1, 3.0, 0.2]], np.float32), (n, 1))
          + np.random.RandomState(4).uniform(-1, 1, (n, 3)).astype(np.float32)
          * np.array([1.0, 0.0, 1.0], np.float32))
    rd = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    ph, pt = _check(js, ro, rd, min_hit_frac=0.99)
    assert ph.all()
    np.testing.assert_allclose(pt, 2.0, atol=1e-4)   # the y = 1 quad
    ph2, pt2 = _check(js, ro, rd, t_lower=pt, min_hit_frac=0.99)
    assert ph2.all()
    np.testing.assert_allclose(pt2, 3.0, atol=1e-4)  # the plane behind it


def test_parallel_slab_rays():
    js = _flat_plane_scene(37)
    n = 256
    rs = np.random.RandomState(5)
    ro = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    ro[:, 1] = np.where(np.arange(n) % 2 == 0, 0.0, 0.5)  # half on the plane
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = 0.0  # exactly parallel
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _check(js, ro, d, min_hit_frac=0.0)


def test_dead_lanes_are_a_clean_miss():
    js = j_mesh_scene(3000, textured=False, accel="always")
    ro, rd = _rays(512, seed=6, origin_box=((-4, 0.5, 1.0), (4, 2.5, 12.0)))
    alive = np.random.RandomState(6).uniform(size=512) >= 0.2
    assert 0.1 < (~alive).mean() < 0.3
    _check(js, ro, rd, alive=alive)


def test_ties_go_to_the_lowest_position():
    """Two copies of every triangle of a plane: with no BVH the lower scene
    id wins; with a BVH the one in the lower BVH slot, as the JAX list
    kernel decides."""
    js = _flat_plane_scene(37)
    g = js.geom
    twice = g.replace(**{f.name: jnp.concatenate([getattr(g, f.name)] * 2)
                         for f in dataclasses.fields(g)})
    ro, rd = _rays(256, seed=7)
    for accel in ("none", "always"):
        jt = finalize_scene(twice, js.materials, None, accel=accel)
        ph, _ = _check(jt, ro, rd, min_hit_frac=0.9)
        assert ph.mean() > 0.9


def test_cpu_tensors_take_the_plain_version():
    ps, _ = from_reference(j_mesh_scene(3000, textured=False, accel="always"))
    ro, rd = (torch.tensor(x) for x in _rays(16, seed=8))
    kernel, plain = KL.intersect_list.launches, KL.intersect_list_plain.launches
    KL.intersect_list(ps.geom, ro, rd, accel=ps.accel)
    assert KL.intersect_list.launches == kernel
    assert KL.intersect_list_plain.launches == plain + 1


def test_prepared_inputs_are_built_once_per_scene():
    """The kernel's inputs (inflated node boxes, BVH-ordered rows, position
    keys) come from the scene's BVH, or from a private one that keeps scene
    ids as positions; they are cached on the geometry."""
    ps, _ = from_reference(j_mesh_scene(3000, textured=False, accel="always"))
    prep = KL._prepare(ps.geom, ps.accel)
    assert KL._prepare(ps.geom, ps.accel) is prep
    perm = ps.accel.perm.long()
    torch.testing.assert_close(prep.nodes[:, :3], ps.accel.bounds_min - 1e-5)
    torch.testing.assert_close(prep.nodes[:, 4:7], ps.accel.bounds_max + 1e-5)
    assert torch.equal(prep.links[:, 2], ps.accel.escape)
    assert torch.equal(prep.tris[:, :3], ps.geom.v0[perm])
    assert torch.equal(prep.pos, torch.arange(ps.num_triangles,
                                              dtype=torch.int32))
    private = KL._prepare(ps.geom, None)
    assert private is not prep
    assert torch.equal(private.pos, private.perm)
    assert sorted(private.perm.tolist()) == list(range(ps.num_triangles))

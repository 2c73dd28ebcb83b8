"""The port's host-side BVH (accel/build.py, accel/native.py) and the scene
plumbing around it, against the JAX package:

* the numpy median-split and the C++ SAH builders give the JAX package's
  arrays exactly, on mesh_scene(3000) and mesh_scene(25_000), and pass
  ``validate_bvh``;
* ``finalize_scene``'s "auto"/"always"/"none" thresholds decide as the JAX
  package's; ``with_accel``, ``Scene.to`` and ``bridge.from_reference``
  carry the BVH leaf for leaf;
* the dense route (K1's plain version) orders triangles, and breaks exact
  ties, by ``scene.accel.perm`` as the JAX ``intersect_pallas`` does in
  interpret mode: idx for idx on exact ties, and on >= 99.9% of random
  Cornell lanes (tests/test_torch_intersect.py's criterion).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrpathtracer_tpu.accel.build import build_bvh as j_build_bvh
from pbrpathtracer_tpu.accel.native import build_bvh_native as j_build_native
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.big_scenes import mesh_scene as j_mesh_scene
from pbrpathtracer_tpu.scene.scene import finalize_scene as j_finalize
from pbrpathtracer_tpu.scene.scene import pack_geometry as j_pack_geometry
from pbrpathtracer_tpu.scene.scene import pack_materials as j_pack_materials
from pbrpathtracer_tpu.scene.scene import MaterialSpec as JMaterialSpec
from pbrpathtracer_tpu.scene.scene import with_accel as j_with_accel
from pbrpathtracer_tpu_torch.accel import native
from pbrpathtracer_tpu_torch.accel.build import (FlatBVH, build_bvh,
                                                 validate_bvh)
from pbrpathtracer_tpu_torch.bridge import from_reference
from pbrpathtracer_tpu_torch.ops.hit import default_intersector
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.scene import (MaterialSpec, finalize_scene,
                                                 pack_geometry,
                                                 pack_materials, with_accel)

FIELDS = ("bounds_min", "bounds_max", "first", "count", "escape", "perm")


def _assert_bvh_equal(jbvh, pbvh):
    assert isinstance(pbvh, FlatBVH)
    assert pbvh.leaf_size == jbvh.leaf_size
    for f in FIELDS:
        j, p = np.asarray(getattr(jbvh, f)), getattr(pbvh, f).numpy()
        assert p.dtype == j.dtype, f
        np.testing.assert_array_equal(p, j, err_msg=f)


def _vertices(n):
    g = j_mesh_scene(n, textured=False, accel="none").geom
    v0, v1, v2 = (np.asarray(x) for x in g.vertices())
    return v0, v1, v2


@pytest.mark.parametrize("n", [3000, 25_000])
@pytest.mark.parametrize("builder", ["numpy", "native"])
def test_builders_match_jax(builder, n):
    v0, v1, v2 = _vertices(n)
    if builder == "numpy":
        ref, got = j_build_bvh(v0, v1, v2), build_bvh(v0, v1, v2)
    else:
        ref = j_build_native(v0, v1, v2)
        got = native.build_bvh_native(v0, v1, v2)
    _assert_bvh_equal(ref, got)
    validate_bvh(got, v0.shape[0])


def test_native_builder_is_built_from_the_jax_source():
    """The port compiles its own copy of the JAX package's C++ BVH source,
    inside its package; the two files are byte-equal, so they cannot drift."""
    from pbrpathtracer_tpu.accel import native as j_native
    assert native.SRC.startswith(native._PKG)
    assert native.SRC.endswith("csrc/bvh_builder.cpp")
    assert native.LIB_PATH.startswith(
        native._PKG) and "_build" in native.LIB_PATH
    j_src = os.path.join(os.path.dirname(os.path.abspath(j_native.__file__)),
                         "cpp", "bvh_builder.cpp")
    assert os.path.realpath(j_src) != os.path.realpath(native.SRC)
    with open(j_src, "rb") as a, open(native.SRC, "rb") as b:
        assert a.read() == b.read()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No silent fall back to the numpy builder."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", str(tmp_path / "missing.cpp"))
    v0, v1, v2 = _vertices(3000)
    with pytest.raises(RuntimeError):
        native.build_bvh_native(v0, v1, v2)
    with pytest.raises(RuntimeError):
        native.build_bvh_auto(v0, v1, v2, native_threshold=1)


def test_validate_bvh_catches_a_broken_tree():
    v0, v1, v2 = _vertices(3000)
    bvh = build_bvh(v0, v1, v2)
    escape = bvh.escape.clone()
    escape[0] = 0
    with pytest.raises(AssertionError):
        validate_bvh(dataclasses.replace(bvh, escape=escape), v0.shape[0])


def _soup(T, seed=0):
    rs = np.random.RandomState(seed)
    v0 = rs.uniform(-1, 1, (T, 3)).astype(np.float32)
    tris = {"v0": v0,
            "v1": v0 + rs.uniform(-0.1, 0.1, (T, 3)).astype(np.float32),
            "v2": v0 + rs.uniform(-0.1, 0.1, (T, 3)).astype(np.float32)}
    return tris


@pytest.mark.parametrize("T,accel", [(4096, "auto"), (4097, "auto"),
                                     (100, "always"), (4097, "none")])
def test_finalize_scene_thresholds_match_jax(T, accel):
    tris = _soup(T)
    js = j_finalize(j_pack_geometry(tris), j_pack_materials([JMaterialSpec()]),
                    accel=accel)
    ps = finalize_scene(pack_geometry(tris), pack_materials([MaterialSpec()]),
                        accel=accel)
    assert (ps.accel is None) == (js.accel is None)
    assert (ps.accel is None) == (accel == "none" or
                                  (accel == "auto" and T <= 4096))
    if js.accel is not None:
        _assert_bvh_equal(js.accel, ps.accel)


def test_finalize_scene_rejects_unknown_accel():
    with pytest.raises(ValueError):
        finalize_scene(pack_geometry(_soup(4)),
                       pack_materials([MaterialSpec()]), accel="sometimes")


def test_with_accel_and_from_reference_carry_the_bvh():
    js = j_with_accel(jb.cornell_box())
    ps = with_accel(pb.cornell_box())
    _assert_bvh_equal(js.accel, ps.accel)
    carried, _ = from_reference(js)
    _assert_bvh_equal(js.accel, carried.accel)
    assert from_reference(jb.cornell_box())[0].accel is None
    moved = carried.to("cpu")
    _assert_bvh_equal(js.accel, moved.accel)
    assert moved.accel.num_nodes == js.accel.num_nodes


def _rays(seed, n):
    rs = np.random.RandomState(seed)
    ro = rs.uniform([-0.95, -0.95, 0.05], [0.95, 0.95, 3.95],
                    (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    rd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_lower = np.where(rs.uniform(size=n) < 0.3, rs.uniform(0, 2, n),
                       0.0).astype(np.float32)
    alive = rs.uniform(size=n) < 0.8
    return ro, rd, t_lower, alive


def _dense_both(js, ro, rd, t_lower, alive):
    from jax.experimental.pallas import tpu as pltpu
    from pbrpathtracer_tpu.kernels.intersect_pallas import intersect_pallas
    with pltpu.force_tpu_interpret_mode():
        ref = intersect_pallas(js, jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(t_lower), alive=jnp.asarray(alive))
    ps, _ = from_reference(js)
    got = default_intersector(ps, torch.tensor(ro), torch.tensor(rd),
                              torch.tensor(t_lower), torch.tensor(alive))
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def test_dense_route_orders_by_accel_perm():
    """tests/test_torch_intersect.py's criterion: hit and idx identical on
    >= 99.9% of lanes, |dt| <= 1e-5 where they agree. Measured: 4095 of
    4096 lanes; the other is a 1-ulp near-tie where a box meets the floor,
    which XLA's contracted arithmetic and the port's op-by-op order decide
    apart (the same lane differs without a BVH)."""
    js = j_with_accel(jb.cornell_box())
    (rh, ri, rt, _, _), (ph, pi, pt, _, _) = _dense_both(js, *_rays(0, 4096))
    same = (rh == ph) & (ri == pi)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(pt[same], rt[same], rtol=0, atol=1e-5)


def test_dense_route_breaks_ties_by_accel_perm():
    """Cornell's triangles twice, under a BVH whose perm puts every second
    copy first: the exact-t ties go to the second copies, as in JAX."""
    js = jb.cornell_box()
    g = js.geom
    T = g.num_triangles
    twice = g.replace(**{f.name: jnp.concatenate([getattr(g, f.name)] * 2)
                         for f in dataclasses.fields(g)})
    js = j_with_accel(js.replace(geom=twice))
    flipped = np.asarray(js.accel.perm)
    flipped = np.where(flipped < T, flipped + T, flipped - T).astype(np.int32)
    js = js.replace(accel=js.accel.replace(perm=jnp.asarray(flipped)))
    (rh, ri, _, _, _), (ph, pi, _, _, _) = _dense_both(js, *_rays(1, 1024))
    np.testing.assert_array_equal(ph, rh)
    np.testing.assert_array_equal(pi, ri)
    assert ph.mean() > 0.5 and (pi[ph] >= T).all()

"""The plain version of the port's closest-hit kernel (the route CPU tensors
take, and the version the CUDA kernel is held against on the card) against
the JAX package: the Pallas kernel ``intersect_pallas`` in interpret mode and
the jnp ``intersect_classic``.

Criteria: hit and idx identical on >= 99.9% of lanes, |dt|, |du|, |dv| <=
1e-5 where the winners agree, and dead lanes a clean miss (hit False,
idx = t = u = v = 0). Measured on these inputs: winners agree on 100% of
lanes against the Pallas kernel and on 99.95% (Cornell, 2 of 4096 lanes) and
100% (spheres) against intersect_classic, with |dt, du, dv| <= 2.2e-6. XLA's
CPU compiler fuses and contracts the arithmetic, so the JAX results are not
bit-equal to the port's op-by-op ones.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.ops.intersect import intersect_classic as j_classic
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import pack_geometry as j_pack_geometry
from pbrpathtracer_tpu_torch import bridge
from pbrpathtracer_tpu_torch.kernels import intersect as K
from pbrpathtracer_tpu_torch.scene.scene import pack_geometry
from pbrpathtracer_tpu_torch.utils import observability as obs

# The port's scenes live on the card by default; these tests run on the CPU.
from_reference = functools.partial(bridge.from_reference, device="cpu")

SCENES = ["cornell_box", "cornell_spheres_scene"]


def _rays(seed, n):
    """Rays from inside the room, random directions, 30% with a random
    t_lower, 20% dead."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform([-0.95, -0.95, 0.05], [0.95, 0.95, 3.95],
                    (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    rd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_lower = np.where(rs.uniform(size=n) < 0.3, rs.uniform(0, 2, n),
                       0.0).astype(np.float32)
    alive = rs.uniform(size=n) < 0.8
    return ro, rd, t_lower, alive


def _port(geom, ro, rd, t_lower, alive):
    out = K.intersect_dense(geom, torch.tensor(ro), torch.tensor(rd),
                            torch.tensor(t_lower), torch.tensor(alive))
    return [x.numpy() for x in out]


def _assert_agree(ref, port, alive):
    rh, ri, rt, ru, rv = (np.asarray(x) for x in ref)
    ph, pi, pt, pu, pv = port
    same = (rh == ph) & (ri == pi)
    assert same.mean() >= 0.999, f"winners agree on {same.mean():.4%}"
    both = same & ph
    assert both.any()
    for a, b in ((rt, pt), (ru, pu), (rv, pv)):
        assert np.abs(a[both] - b[both]).max() <= 1e-5
    dead = ~alive
    assert dead.any()
    assert not ph[dead].any()
    for x in (pi, pt, pu, pv):
        assert (x[dead] == 0).all()
    assert ((pt == 0) & (pu == 0) & (pv == 0) & (pi == 0))[~ph].all()


@pytest.mark.parametrize("name", SCENES)
def test_plain_matches_pallas_interpret(name):
    from jax.experimental.pallas import tpu as pltpu
    from pbrpathtracer_tpu.kernels.intersect_pallas import intersect_pallas

    js = getattr(jb, name)()
    ps, _ = from_reference(js)
    ro, rd, t_lower, alive = _rays(0, 1024)
    with pltpu.force_tpu_interpret_mode():
        ref = intersect_pallas(js.geom, jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(t_lower), alive=jnp.asarray(alive))
    _assert_agree(ref, _port(ps.geom, ro, rd, t_lower, alive), alive)


@pytest.mark.parametrize("name", SCENES)
def test_plain_matches_intersect_classic(name):
    js = getattr(jb, name)()
    ps, _ = from_reference(js)
    ro, rd, t_lower, alive = _rays(1, 4096)
    ref = jax.jit(lambda: j_classic(js.geom, jnp.asarray(ro), jnp.asarray(rd),
                                    jnp.asarray(t_lower),
                                    alive=jnp.asarray(alive)))()
    _assert_agree(ref, _port(ps.geom, ro, rd, t_lower, alive), alive)


def _single_tri():
    tris = {"v0": np.array([[-1, -1, 2]], np.float32),
            "v1": np.array([[1, -1, 2]], np.float32),
            "v2": np.array([[0, 1, 2]], np.float32)}
    return j_pack_geometry(tris), pack_geometry(tris)


def test_single_triangle_hit_miss():
    jg, pg = _single_tri()
    ro = np.array([[0, 0, 0], [0, 0, 0], [0, 0, 3], [5, 5, 0]], np.float32)
    rd = np.array([[0, 0, 1], [0, 0, -1], [0, 0, -1], [0, 0, 1]], np.float32)
    zeros, ones = np.zeros(4, np.float32), np.ones(4, bool)
    ph, pi, pt, pu, pv = _port(pg, ro, rd, zeros, ones)
    assert ph.tolist() == [True, False, True, False]
    assert abs(pt[0] - 2.0) < 1e-5 and abs(pt[2] - 1.0) < 1e-5
    ref = j_classic(jg, jnp.asarray(ro), jnp.asarray(rd))
    for a, b in zip(ref, (ph, pi, pt, pu, pv)):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_t_lower_excludes_near_hits():
    _, pg = _single_tri()
    ro = np.zeros((2, 3), np.float32)
    rd = np.array([[0, 0, 1], [0, 0, 1]], np.float32)
    ph, _, pt, _, _ = _port(pg, ro, rd, np.array([2.5, 1.5], np.float32),
                            np.ones(2, bool))
    assert ph.tolist() == [False, True] and abs(pt[1] - 2.0) < 1e-5


def test_ties_go_to_the_lowest_id():
    """Two copies of one triangle: every hit must report the first."""
    tris = {"v0": np.array([[-1, -1, 2]] * 2, np.float32),
            "v1": np.array([[1, -1, 2]] * 2, np.float32),
            "v2": np.array([[0, 1, 2]] * 2, np.float32)}
    ro = np.array([[0, 0, 0], [0.2, -0.5, 0]], np.float32)
    rd = np.array([[0, 0, 1], [0, 0, 1]], np.float32)
    ph, pi, _, _, _ = _port(pack_geometry(tris), ro, rd,
                            np.zeros(2, np.float32), np.ones(2, bool))
    assert ph.all() and (pi == 0).all()


def test_perm_maps_ids_back_to_scene_order():
    ps, _ = from_reference(jb.cornell_box())
    ro, rd, t_lower, alive = (torch.tensor(x) for x in _rays(2, 2048))
    perm = torch.tensor(np.random.RandomState(0).permutation(
        ps.num_triangles).astype(np.int32))
    base = K.intersect_dense(ps.geom, ro, rd, t_lower, alive)
    permuted = K.intersect_dense(ps.geom, ro, rd, t_lower, alive, perm=perm)
    same = (base[0] == permuted[0]) & (base[1] == permuted[1])
    assert same.float().mean() >= 0.999
    torch.testing.assert_close(permuted[2][same], base[2][same], rtol=0,
                               atol=0)


def test_cpu_tensors_take_the_plain_version():
    ps, _ = from_reference(jb.cornell_box())
    ro, rd, t_lower, alive = (torch.tensor(x) for x in _rays(3, 64))
    _, moved = obs.counted(
        lambda: K.intersect_dense(ps.geom, ro, rd, t_lower, alive))
    assert moved == {"intersect_dense_plain": 1}


def test_wrapper_rejects_bad_inputs():
    ps, _ = from_reference(jb.cornell_box())
    ro, rd, t_lower, alive = (torch.tensor(x) for x in _rays(4, 16))
    with pytest.raises(TypeError):
        K.intersect_dense(ps.geom, ro.double(), rd, t_lower, alive)
    with pytest.raises(TypeError):
        K.intersect_dense(ps.geom, ro, rd, t_lower, alive.float())
    with pytest.raises(ValueError):
        K.intersect_dense(ps.geom, ro.T.contiguous().T, rd, t_lower, alive)
    with pytest.raises(ValueError):
        K.intersect_dense(ps.geom, ro[:8], rd, t_lower, alive)


def test_scenes_over_2048_triangles_raise():
    g = from_reference(jb.cornell_box())[0].geom
    reps = 2049 // g.num_triangles + 1
    big = dataclasses.replace(g, **{
        f.name: getattr(g, f.name).repeat(reps, *([1] * (getattr(g, f.name).dim() - 1)))
        for f in dataclasses.fields(g)})
    ro, rd, t_lower, alive = (torch.tensor(x) for x in _rays(5, 16))
    with pytest.raises(NotImplementedError):
        K.intersect_dense(big, ro, rd, t_lower, alive)


# ---- the kernel's per-geometry set-up (runs on CPU tensors too) -------------

def _old_setup(geom, perm):
    """The rows and boxes as the wrapper built them on every query before
    the set-up was hoisted: the perm-ordered (v0, e1, e2) rows and the
    EPS-inflated (lo, hi) box of each chunk."""
    p = slice(None) if perm is None else perm.long()
    v0, e1, e2 = geom.v0[p], geom.e1[p], geom.e2[p]
    T = v0.shape[0]
    chunk = min(512, max(8, (T + 7) // 8 * 8))
    n_chunks = (T + chunk - 1) // chunk
    corners = torch.stack([v0, v0 + e1, v0 + e2])
    boxes = []
    for c in range(n_chunks):
        block = corners[:, c * chunk:(c + 1) * chunk].reshape(-1, 3)
        boxes.append(torch.cat([block.amin(dim=0) - 1e-5,
                                block.amax(dim=0) + 1e-5]))
    return torch.cat([v0, e1, e2], dim=1), torch.stack(boxes), chunk


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("with_perm", [False, True])
def test_prepare_builds_the_rows_and_boxes_once(name, with_perm):
    ps, _ = from_reference(getattr(jb, name)())
    perm = torch.tensor(np.random.RandomState(1).permutation(
        ps.num_triangles).astype(np.int32)) if with_perm else None
    prep = K._prepare(ps.geom, perm)
    tris, boxes, chunk = _old_setup(ps.geom, perm)
    assert prep.chunk == chunk == K._chunking(ps.num_triangles)[0]
    assert prep.tris.shape == (ps.num_triangles, 9)
    assert prep.boxes.shape == (K.dense_chunks(ps.num_triangles), 6)
    assert prep.tris.is_contiguous() and prep.boxes.is_contiguous()
    torch.testing.assert_close(prep.tris, tris, rtol=0, atol=0)
    torch.testing.assert_close(prep.boxes, boxes, rtol=0, atol=0)
    if with_perm:
        assert prep.perm.is_contiguous() and torch.equal(prep.perm, perm)
    else:
        assert prep.perm is None
    # a second query of the same (geometry, perm) finds the same object
    assert K._prepare(ps.geom, perm) is prep


def test_prepare_is_keyed_by_the_perm_and_by_the_geometry():
    ps, _ = from_reference(jb.cornell_box())
    T = ps.num_triangles
    perm_a = torch.arange(T, dtype=torch.int32).flip(0).contiguous()
    perm_b = perm_a.clone()
    none = K._prepare(ps.geom, None)
    a = K._prepare(ps.geom, perm_a)
    assert a is not none and torch.equal(a.tris, none.tris.flip(0))
    assert K._prepare(ps.geom, perm_a) is a
    # an equal perm that is another tensor is prepared afresh
    b = K._prepare(ps.geom, perm_b)
    assert b is not a and torch.equal(b.tris, a.tris)
    # a replaced geometry gets none of the first one's cache
    moved = dataclasses.replace(ps.geom, v0=ps.geom.v0 + 1.0)
    assert getattr(moved, "_k1_prepared", None) is None
    m = K._prepare(moved, perm_b)
    assert m is not b
    torch.testing.assert_close(m.tris[:, :3], b.tris[:, :3] + 1.0, rtol=0,
                               atol=0)
    torch.testing.assert_close(m.boxes, b.boxes + 1.0, rtol=0, atol=2e-6)
    assert K._prepare(ps.geom, perm_b) is b


@pytest.mark.parametrize("with_perm", [False, True])
def test_optional_t_lower_and_alive(with_perm):
    """None means no lower bound and every lane alive."""
    ps, _ = from_reference(jb.cornell_box())
    ro, rd, _, _ = (torch.tensor(x) for x in _rays(6, 512))
    perm = torch.tensor(np.random.RandomState(2).permutation(
        ps.num_triangles).astype(np.int32)) if with_perm else None
    got = K.intersect_dense(ps.geom, ro, rd, perm=perm)
    ref = K.intersect_dense(ps.geom, ro, rd, torch.zeros(512),
                            torch.ones(512, dtype=torch.bool), perm=perm)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    with pytest.raises(TypeError):
        K.intersect_dense(ps.geom, ro, rd, perm=perm.long() if with_perm
                          else torch.zeros(ps.num_triangles))
    with pytest.raises(ValueError):
        K.intersect_dense(ps.geom, ro, rd, perm=torch.zeros(
            3, dtype=torch.int32))

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

Below them, the layout and the walk of the CUDA kernel, held without a card:
the 4-wide tree (``collapse_bvh``) against a loop version of the collapse,
and ``walk_plain`` (the kernel's walk in plain torch) against the brute-force
plain version and against a binary walk's counts.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.scene.big_scenes import mesh_scene as j_mesh_scene
from pbrpathtracer_tpu.scene.scene import (MaterialSpec, finalize_scene,
                                           pack_geometry, pack_materials)
from pbrpathtracer_tpu_torch import bridge
from pbrpathtracer_tpu_torch.accel.native import (build_bvh_auto,
                                                  build_bvh_native)
from pbrpathtracer_tpu_torch.kernels import intersect_list as KL
from pbrpathtracer_tpu_torch.ops.hit import default_intersector
from pbrpathtracer_tpu_torch.ops.intersect import hit_tests, moller_trumbore
from pbrpathtracer_tpu_torch.utils import observability as obs

# The port's scenes live on the card by default; these tests run on the CPU.
from_reference = functools.partial(bridge.from_reference, device="cpu")


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
    out, moved = obs.counted(lambda: default_intersector(
        ps, torch.tensor(ro), torch.tensor(rd), torch.tensor(t_lower),
        torch.tensor(alive)))
    assert moved == {"intersect_list_plain": 1}
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
    _, moved = obs.counted(
        lambda: KL.intersect_list(ps.geom, ro, rd, accel=ps.accel))
    assert moved == {"intersect_list_plain": 1}


def test_counting_twin_refuses_cpu_tensors():
    """The counting kernel has no plain version to take: on the CPU the
    counts come from ``walk_plain``."""
    ps, _ = from_reference(j_mesh_scene(3000, textured=False, accel="always"))
    ro, rd = (torch.tensor(x) for x in _rays(16, seed=8))
    with pytest.raises(ValueError, match="CUDA"):
        KL.intersect_list_stats(ps.geom, ro, rd, accel=ps.accel)


def test_prepared_inputs_are_built_once_per_scene():
    """The kernel's inputs (the wide tree with inflated child boxes,
    BVH-ordered rows of three padded float4) come from the scene's BVH, or
    from a private one that keeps scene ids as positions; they are cached
    on the geometry."""
    ps, _ = from_reference(j_mesh_scene(3000, textured=False, accel="always"))
    prep = KL._prepare(ps.geom, ps.accel)
    assert KL._prepare(ps.geom, ps.accel) is prep
    perm = ps.accel.perm.long()
    boxes, kids = _boxes_and_children(prep)
    used = kids[0] != KL.EMPTY
    torch.testing.assert_close(boxes[0, 0:3][:, used].amin(dim=1),
                               ps.accel.bounds_min[0] - 1e-5)
    torch.testing.assert_close(boxes[0, 3:6][:, used].amax(dim=1),
                               ps.accel.bounds_max[0] + 1e-5)
    assert prep.tris.shape == (ps.num_triangles, 12)
    assert torch.equal(prep.tris[:, 0:3], ps.geom.v0[perm])
    assert torch.equal(prep.tris[:, 4:7], ps.geom.e1[perm])
    assert torch.equal(prep.tris[:, 8:11], ps.geom.e2[perm])
    assert not prep.tris[:, 3::4].any()
    assert prep.pos is None              # the slot is its own position
    assert torch.equal(prep.perm, ps.accel.perm)
    private = KL._prepare(ps.geom, None)
    assert private is not prep
    assert torch.equal(private.pos, private.perm)
    assert sorted(private.perm.tolist()) == list(range(ps.num_triangles))


# ---- the wide tree and the walk over it (what the CUDA kernel reads and
# does), held here without a card ----

def _boxes_and_children(prep):
    """(f32[M, 6, WIDTH] child boxes, i32[M, WIDTH] children) of the
    records."""
    words = 6 * KL.WIDTH
    boxes = prep.nodes[:, :words].contiguous().view(torch.float32)
    return (boxes.reshape(-1, 6, KL.WIDTH),
            prep.nodes[:, words:words + KL.WIDTH])


def _wide_case(case):
    """(port scene, the binary BVH its wide tree was collapsed from)."""
    if case == "flat":
        ps, _ = from_reference(_flat_plane_scene(
            37, extra_quads=((1.0, 4.0),)))
    else:
        ps, _ = from_reference(j_mesh_scene(
            3000, textured=False, accel="always" if case == "always"
            else "auto"))
    if case == "native":     # the C++ SAH tree as the scene's own
        v0, v1, v2 = (x.numpy() for x in ps.geom.vertices())
        ps = dataclasses.replace(ps, accel=build_bvh_native(v0, v1, v2))
    assert (ps.accel is None) == (case in ("auto", "flat"))
    prep = KL._prepare(ps.geom, ps.accel)
    if ps.accel is not None:
        return ps, prep, ps.accel
    # the private tree: rebuilt here, equal by its perm
    v0, v1, v2 = (x.numpy() for x in ps.geom.vertices())
    bvh = build_bvh_auto(v0, v1, v2)
    assert torch.equal(bvh.perm, prep.perm)
    return ps, prep, bvh


@pytest.mark.parametrize("case", ["auto", "always", "native", "flat"])
def test_wide_tree_invariants(case):
    """Against a loop version of the collapse: every wide node stands for
    one interior binary node and holds that node's grandchildren (a child
    that is a leaf stays); every child box contains every box of the binary
    subtree it stands for and every triangle in it; every slot lies in
    exactly one leaf child; every wide node but the root has one parent;
    records are 128-byte multiples."""
    ps, prep, bvh = _wide_case(case)
    assert prep.nodes.dtype == torch.int32
    assert prep.nodes.shape[1] == KL.RECORD_WORDS
    assert prep.nodes.shape[1] * prep.nodes.element_size() % 128 == 0
    assert prep.nodes.is_contiguous() and prep.tris.is_contiguous()
    boxes, kids = (x.numpy() for x in _boxes_and_children(prep))
    first, count, escape = (getattr(bvh, f).numpy()
                            for f in ("first", "count", "escape"))
    bmin, bmax = bvh.bounds_min.numpy(), bvh.bounds_max.numpy()
    tri = prep.tris.numpy()
    corners = np.stack([tri[:, 0:3], tri[:, 0:3] + tri[:, 4:7],
                        tri[:, 0:3] + tri[:, 8:11]])       # [3, T, 3]
    slot_seen = np.zeros(ps.num_triangles, int)
    wide_seen = np.zeros(prep.nodes.shape[0], int)

    def binary_children(b):
        out = []
        for c in (b + 1, escape[b + 1]):
            out += [c] if count[c] > 0 else [c + 1, escape[c + 1]]
        return out

    def check(w, b, level):
        wide_seen[w] += 1
        mine = [(k, c) for k, c in enumerate(kids[w]) if c != KL.EMPTY]
        assert 2 <= len(mine) <= KL.WIDTH
        deepest = level
        for (k, c), kb in zip(mine, binary_children(b), strict=True):
            lo, hi = boxes[w, 0:3, k], boxes[w, 3:6, k]
            sub = slice(kb, escape[kb])
            assert (lo <= bmin[sub]).all() and (hi >= bmax[sub]).all()
            leaves = np.arange(kb, escape[kb])[count[sub] > 0]
            s0, s1 = first[leaves[0]], first[leaves[-1]] + count[leaves[-1]]
            # f32 corners v0 + e carry a rounding error below the inflation
            assert (lo - 1e-6 <= corners[:, s0:s1]).all()
            assert (hi + 1e-6 >= corners[:, s0:s1]).all()
            if c < 0:
                code = ~int(c)
                assert count[kb] > 0
                assert code >> KL.COUNT_BITS == first[kb]
                assert code & ((1 << KL.COUNT_BITS) - 1) == count[kb]
                slot_seen[first[kb]:first[kb] + count[kb]] += 1
            else:
                assert count[kb] == 0 and c > w
                deepest = max(deepest, check(int(c), kb, level + 1))
        return deepest

    assert check(0, 0, 1) == prep.depth
    assert (slot_seen == 1).all()
    assert (wide_seen == 1).all()
    assert (KL.WIDTH - 1) * prep.depth <= KL.STACK_DEPTH


def test_wide_tree_of_a_single_leaf():
    """A BVH that is one leaf: a root record with one child."""
    rec, depth = KL.collapse_bvh(
        np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32),
        np.array([0]), np.array([5]), np.array([1]))
    assert depth == 1 and rec.shape == (1, KL.RECORD_WORDS)
    kids = rec[0, 6 * KL.WIDTH:7 * KL.WIDTH].tolist()
    assert kids == [~5, KL.EMPTY, KL.EMPTY, KL.EMPTY]


def test_collapse_refuses_what_the_walk_cannot_take():
    z = np.zeros((1, 3), np.float32)
    with pytest.raises(ValueError, match="leaf of 16"):
        KL.collapse_bvh(z, z, np.array([0]), np.array([16]), np.array([1]))


def _walk_query(ps, ro, rd, t_lower=None, alive=None):
    """walk_plain over the scene's prepared layout, and the brute-force
    plain version on the same query."""
    n = ro.shape[0]
    ro, rd = torch.tensor(ro), torch.tensor(rd)
    t_lower = torch.tensor(np.zeros(n, np.float32) if t_lower is None
                           else t_lower)
    alive = torch.tensor(np.ones(n, bool) if alive is None else alive)
    prep = KL._prepare(ps.geom, ps.accel)
    walk = KL.walk_plain(prep, ro, rd, t_lower, alive)
    plain = KL.intersect_list_plain(
        ps.geom, ro, rd, t_lower, alive,
        None if ps.accel is None else ps.accel.perm)
    return walk, plain, alive


def _check_walk(ps, ro, rd, t_lower=None, alive=None, min_hit_frac=0.4):
    """hit and id identical on every lane, t, u, v within 1e-6 (measured:
    bit-equal, the arithmetic is the same op for op), dead lanes clean and
    uncounted."""
    walk, plain, alive = _walk_query(ps, ro, rd, t_lower, alive)
    wh, wi, wt, wu, wv, n_nodes, n_tris = walk
    assert torch.equal(wh, plain[0]) and torch.equal(wi, plain[1])
    for a, b in zip((wt, wu, wv), plain[2:]):
        assert float((a - b).abs().max()) <= 1e-6
    assert float(wh.float().mean()) >= min_hit_frac * float(
        alive.float().mean())
    assert not wh[~alive].any()
    assert not n_nodes[~alive].any() and not n_tris[~alive].any()
    assert bool((n_nodes[alive] >= 1).all())
    return walk


@pytest.mark.parametrize("accel", ["auto", "always"])
def test_walk_matches_plain_on_random_rays(accel):
    ps, _ = from_reference(j_mesh_scene(3000, textured=False, accel=accel))
    ro, rd = _rays(2048, seed=11,
                   origin_box=((-4, 0.5, 1.0), (4, 2.5, 12.0)))
    _check_walk(ps, ro, rd)


def test_walk_matches_plain_with_dead_lanes():
    ps, _ = from_reference(j_mesh_scene(3000, textured=False, accel="always"))
    ro, rd = _rays(1024, seed=12,
                   origin_box=((-4, 0.5, 1.0), (4, 2.5, 12.0)))
    alive = np.random.RandomState(12).uniform(size=1024) >= 0.5
    _check_walk(ps, ro, rd, alive=alive)


def test_walk_matches_plain_on_a_t_lower_retrace():
    ps, _ = from_reference(_flat_plane_scene(37, extra_quads=((1.0, 4.0),)))
    n = 256
    ro = (np.tile(np.array([[0.1, 3.0, 0.2]], np.float32), (n, 1))
          + np.random.RandomState(4).uniform(-1, 1, (n, 3)).astype(np.float32)
          * np.array([1.0, 0.0, 1.0], np.float32))
    rd = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    first = _check_walk(ps, ro, rd, min_hit_frac=0.99)
    np.testing.assert_allclose(first[2].numpy(), 2.0, atol=1e-4)
    again = _check_walk(ps, ro, rd, t_lower=first[2].numpy(),
                        min_hit_frac=0.99)
    np.testing.assert_allclose(again[2].numpy(), 3.0, atol=1e-4)


def test_walk_matches_plain_on_parallel_slab_rays():
    ps, _ = from_reference(_flat_plane_scene(37))
    n = 256
    rs = np.random.RandomState(5)
    ro = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    ro[:, 1] = np.where(np.arange(n) % 2 == 0, 0.0, 0.5)  # half on the plane
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = 0.0  # exactly parallel
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _check_walk(ps, ro, d, min_hit_frac=0.0)


@pytest.mark.parametrize("accel", ["none", "always"])
def test_walk_ties_go_to_the_lowest_position(accel):
    """test_ties_go_to_the_lowest_position's scene: two copies of every
    triangle, so every hit is an exact tie that the visit order must not
    decide."""
    js = _flat_plane_scene(37)
    g = js.geom
    twice = g.replace(**{f.name: jnp.concatenate([getattr(g, f.name)] * 2)
                         for f in dataclasses.fields(g)})
    ps, _ = from_reference(finalize_scene(twice, js.materials, None,
                                          accel=accel))
    ro, rd = _rays(256, seed=7)
    walk = _check_walk(ps, ro, rd, min_hit_frac=0.9)
    if accel == "none":      # scene ids are the positions: the first copy
        assert int(walk[1][walk[0]].max()) < g.v0.shape[0]


def _binary_dfs_counts(bvh, prep, ro, rd):
    """Node records read and triangles tested per ray by a walk of the
    binary FlatBVH in its fixed depth-first order over the escape links,
    pruned by the running best t: the walk the wide one replaced."""
    ro, rd = torch.tensor(ro), torch.tensor(rd)
    n, M = ro.shape[0], bvh.num_nodes
    inv = 1.0 / torch.where(rd.abs() < KL.TINY,
                            torch.where(rd < 0, -KL.TINY, KL.TINY), rd)
    lo, hi = bvh.bounds_min - 1e-5, bvh.bounds_max + 1e-5
    first, count, escape = (getattr(bvh, f).long()
                            for f in ("first", "count", "escape"))
    i = torch.zeros(n, dtype=torch.int64)
    best_t = torch.full((n,), 3.0e38)
    n_nodes = torch.zeros(n, dtype=torch.int64)
    n_tris = torch.zeros(n, dtype=torch.int64)
    zeros = torch.zeros(n)
    while bool((i < M).any()):
        act = (i < M).nonzero()[:, 0]
        node = i[act]
        t1 = (lo[node] - ro[act]) * inv[act]
        t2 = (hi[node] - ro[act]) * inv[act]
        tn = torch.minimum(t1, t2).amax(dim=1)
        tf = torch.maximum(t1, t2).amin(dim=1)
        enter = (tn < tf) & (tf > 0) & (tn <= best_t[act])
        n_nodes[act] += 1
        i[act] = torch.where(enter, node + 1, escape[node])
        rows, leaf = act[enter], node[enter]
        n_tris[rows] += count[leaf]
        for j in range(int(count[leaf].max()) if leaf.numel() else 0):
            m = j < count[leaf]
            r = rows[m]
            tri = prep.tris[first[leaf[m]] + j]
            a, u_num, v_num, t_num = moller_trumbore(
                *ro[r].unbind(1), *rd[r].unbind(1), tri[:, 0], tri[:, 1],
                tri[:, 2], tri[:, 4], tri[:, 5], tri[:, 6], tri[:, 8],
                tri[:, 9], tri[:, 10])
            t = hit_tests(a[:, None], u_num[:, None], v_num[:, None],
                          t_num[:, None], zeros[r])[0][:, 0]
            best_t[r] = torch.minimum(best_t[r], t)
    return n_nodes, n_tris, best_t


def test_wide_walk_reads_fewer_records_than_the_binary_walk():
    """On mesh_scene(3000): the 4-wide near-first walk reads fewer node
    records per ray in the mean, and tests no more triangles, than the
    binary walk in fixed order; both find the same t."""
    ps, _ = from_reference(j_mesh_scene(3000, textured=False, accel="always"))
    ro, rd = _rays(512, seed=13, origin_box=((-4, 0.5, 1.0), (4, 2.5, 12.0)))
    walk, _, _ = _walk_query(ps, ro, rd)
    b_nodes, b_tris, b_t = _binary_dfs_counts(
        ps.accel, KL._prepare(ps.geom, ps.accel), ro, rd)
    hit = walk[0]
    assert torch.equal(b_t[hit], walk[2][hit])
    assert bool((b_t[~hit] > 1e38).all())
    wide_mean = float(walk[5].float().mean())
    binary_mean = float(b_nodes.float().mean())
    print(f"node records per ray: wide {wide_mean:.2f} (max "
          f"{int(walk[5].max())}), binary {binary_mean:.2f} (max "
          f"{int(b_nodes.max())}); triangles tested per ray: wide "
          f"{float(walk[6].float().mean()):.2f}, binary "
          f"{float(b_tris.float().mean()):.2f}")
    assert wide_mean < 0.5 * binary_mean
    assert float(walk[6].float().mean()) <= float(b_tris.float().mean())

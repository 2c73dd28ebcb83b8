"""The port's CUDA kernels against their plain torch versions, and its
compiled forward, fwd+bwd and sharded entries (``engine/compiled.py``)
against the eager render, the eager fwd+bwd and the eager sharded
programs, on the card.

Every test here needs a CUDA card and skips without one. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

K1, K2 and K4 are built to agree with their plain versions bit for bit
(``--fmad=false``, IEEE division), so those comparisons are exact. K4's walk is also held against ``walk_plain``, the same walk in
plain torch, counts included, and its counting twin against itself. K3 sums in
double in a fixed order: it is held to an f64 reference at rtol 1e-6, atol
1e-5 and must give the same bits on every call; its plain version
(``index_add_`` with float atomics on the card) agrees to f32 round-off.
"""

import collections
import dataclasses
import time

import numpy as np
import pytest
import torch

import _shade_cases as shade_cases
from _torch_common import watchdog  # noqa: F401  (autouse)
from chip_smoke import eager_render, flat_plane_scene
from pbrpathtracer_tpu_torch import (Camera, RenderConfig, builders,
                                     grad_render, render)
from pbrpathtracer_tpu_torch.kernels import intersect as KI
from pbrpathtracer_tpu_torch.kernels import intersect_list as KL
from pbrpathtracer_tpu_torch.kernels import packgather as KP
from pbrpathtracer_tpu_torch.ops.integrator import render_sample
from pbrpathtracer_tpu_torch.scene.big_scenes import (mesh_scene,
                                                      mesh_scene_camera)
from pbrpathtracer_tpu_torch.scene.scene import finalize_scene, pack_geometry
from pbrpathtracer_tpu_torch.utils import observability as obs

pytestmark = pytest.mark.gpu

KERNELS = ("intersect_dense", "intersect_dense_plain", "intersect_list",
           "intersect_list_plain", "gather_rows_t", "gather_rows_t_plain",
           "gather_rows_t_bwd", "gather_rows_t_bwd_plain")


def _ran(fn):
    """(``fn()``, the launches it made by wrapper, 0 for the ones it did
    not make), after the card has finished them."""
    out, moved = obs.counted(fn)
    torch.cuda.synchronize()
    return out, _launches(moved)


def _launches(counts):
    return {k: counts.get(k, 0) for k in KERNELS}

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _rays(seed, n, dev):
    rs = np.random.RandomState(seed)
    ro = rs.uniform([-0.95, -0.95, 0.05], [0.95, 0.95, 3.95], (n, 3))
    d = rs.normal(size=(n, 3))
    rd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t_lower = np.where(rs.uniform(size=n) < 0.3, rs.uniform(0, 2, n), 0.0)
    alive = rs.uniform(size=n) < 0.8
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.tensor(ro, **f32), torch.tensor(rd, **f32),
            torch.tensor(t_lower, **f32),
            torch.tensor(alive, dtype=torch.bool, device=dev))


@pytest.mark.parametrize("name", ["cornell_box", "cornell_spheres_scene",
                                  "translucent_scene"])
@pytest.mark.parametrize("n", [1, 100, 65_536])
def test_intersect_kernel_matches_plain(dev, name, n):
    geom = getattr(builders, name)().geom
    args = (geom, *_rays(n, n, dev))
    _assert_same(KI.intersect_dense(*args), KI.intersect_dense_plain(*args))


def test_intersect_kernel_edge_cases(dev):
    """Ties (a duplicated triangle), a flat chunk box with a zero direction
    component on its slab plane, t_lower, dead lanes."""
    quad = {"v0": np.array([[-1, -1, 0], [-1, -1, 0], [-1, -1, 0]], np.float32),
            "v1": np.array([[-1, -1, 4], [-1, -1, 4], [1, -1, 4]], np.float32),
            "v2": np.array([[1, -1, 4], [1, -1, 4], [1, -1, 0]], np.float32)}
    geom = pack_geometry(quad).to(dev)
    lo_x = float(torch.tensor(-1.0) - torch.tensor(1e-5))   # box plane
    ro = torch.tensor([[-0.5, 0, 2], [lo_x, 0, 1], [0.3, 0, 2], [0, 0, 1],
                       [0.5, 0.5, 3]], dtype=torch.float32, device=dev)
    rd = torch.tensor([[0, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, 0],
                       [0, -0.6, -0.8]], dtype=torch.float32, device=dev)
    t_lower = torch.tensor([0, 0, 0.5, 1.5, 0], dtype=torch.float32,
                           device=dev)
    alive = torch.tensor([True, True, True, True, False], device=dev)
    out = KI.intersect_dense(geom, ro, rd, t_lower, alive)
    _assert_same(out, KI.intersect_dense_plain(geom, ro, rd, t_lower, alive))
    assert out[0].tolist() == [True, False, True, False, False]
    assert out[1][0].item() == 0   # tie between rows 0 and 1 -> row 0


@pytest.mark.parametrize("with_perm", [False, True])
@pytest.mark.parametrize("name", ["cornell_box", "cornell_spheres_scene"])
def test_intersect_kernel_optional_inputs_and_perm(dev, name, with_perm):
    """t_lower=None and alive=None reach the kernel as null pointers; the
    kernel maps the winner through ``perm`` itself."""
    geom = getattr(builders, name)().geom
    ro, rd, t_lower, alive = _rays(7, 20_001, dev)
    perm = torch.tensor(np.random.RandomState(3).permutation(
        geom.num_triangles), dtype=torch.int32, device=dev) \
        if with_perm else None
    zeros, ones = torch.zeros_like(t_lower), torch.ones_like(alive)
    _assert_same(KI.intersect_dense(geom, ro, rd, perm=perm),
                 KI.intersect_dense_plain(geom, ro, rd, zeros, ones, perm))
    _assert_same(KI.intersect_dense(geom, ro, rd, t_lower, None, perm=perm),
                 KI.intersect_dense_plain(geom, ro, rd, t_lower, ones, perm))
    out = KI.intersect_dense(geom, ro, rd, t_lower, alive, perm=perm)
    _assert_same(out, KI.intersect_dense_plain(geom, ro, rd, t_lower, alive,
                                               perm))
    for x in out[1:]:
        assert not x[~out[0]].any()


def test_intersect_kernel_prepares_once_per_geometry(dev):
    """A second scene queried between two queries of the first: each
    geometry keeps its own rows, and one query is one launch."""
    a = builders.cornell_box().geom
    b = builders.cornell_spheres_scene().geom
    rays = _rays(8, 4096, dev)
    first = KI.intersect_dense(a, *rays)
    prep = a._k1_prepared[1]
    _assert_same(KI.intersect_dense(b, *rays),
                 KI.intersect_dense_plain(b, *rays))
    again, ran = _ran(lambda: KI.intersect_dense(a, *rays))
    _assert_same(again, first)
    assert ran["intersect_dense"] == 1
    assert a._k1_prepared[1] is prep and b._k1_prepared[1] is not prep


def _k2_shapes():
    """Tables on both sides of the staging limit at W = 1, 7, 9, 13, 55
    (the largest staged table and one row more), with N = 0, one lane short
    of a tile, N % 4 != 0 and N % 4 == 0; and the shapes of the paths."""
    shapes = [(36, 55, 262_144), (2, 13, 1000), (588, 55, 100_000),
              (1000, 55, 77), (256, 7, 0), (49_970, 55, 262_144),
              (1_000_000, 55, 65_536)]
    for W in (1, 7, 9, 13, 55):
        top = KP.FWD_STAGE_BYTES // (4 * W) - 1
        shapes += [(T, W, N) for T in (top, top + 1)
                   for N in (0, 31, 4099, 262_139, 262_144)]
    return shapes


@pytest.mark.parametrize("T,W,N", _k2_shapes())
def test_packgather_kernel_matches_plain(dev, T, W, N):
    """Staged tables and tables read in place, up to the tri packs of the
    50k and 1M mesh scenes, ids in and out of range: bit-equal."""
    rs = np.random.RandomState(T + W + N)
    table = torch.tensor(rs.randn(T, W), dtype=torch.float32, device=dev)
    idx = rs.randint(-2, T + 2, N)
    idx = torch.tensor(idx, dtype=torch.int32, device=dev)
    out = KP.gather_rows_t(table, idx)
    assert out.shape == (W, N) and out.is_contiguous()
    assert torch.equal(out, KP.gather_rows_t_plain(table, idx))


@pytest.mark.parametrize("kind", ["all out of range", "unaligned table",
                                  "unaligned ids"])
@pytest.mark.parametrize("path", ["staged", "in place"])
@pytest.mark.parametrize("W", [9, 55])
def test_packgather_kernel_edge_cases(dev, kind, path, W):
    """Every id out of range; a table and ids that start 4 bytes past a
    16-byte boundary (views into larger buffers: no bulk copy, no int4
    loads of ids)."""
    top = KP.FWD_STAGE_BYTES // (4 * W) - 1
    T = top if path == "staged" else top + 1
    assert KP.fwd_path(T, W) == path
    N = 262_144
    rs = np.random.RandomState(W)
    base = torch.tensor(rs.randn(T * W + 1), dtype=torch.float32, device=dev)
    table = base[:T * W].view(T, W)
    ids = torch.tensor(rs.randint(-2, T + 2, N + 1), dtype=torch.int32,
                       device=dev)
    idx = ids[:N]
    if kind == "all out of range":
        idx = torch.tensor(rs.choice([-1, T, T + 3, -(2 ** 31)], N),
                           dtype=torch.int32, device=dev)
    elif kind == "unaligned table":
        table = base[1:].view(T, W)
        assert table.data_ptr() % 16 != 0
    else:
        idx = ids[1:]
        assert idx.data_ptr() % 16 != 0
    out = KP.gather_rows_t(table, idx)
    assert torch.equal(out, KP.gather_rows_t_plain(table, idx))
    if kind == "all out of range":
        assert not out.any()


def test_packgather_kernel_on_a_bounce_segment(dev):
    """The ids that a bounce (segment 2) of a 50k-scene render fetches: the
    tri pack read in place, bit-equal."""
    from chip_smoke import capture_fetches
    from pbrpathtracer_tpu_torch.ops import shadepack as sp
    scene = mesh_scene(50_000)
    cfg = RenderConfig(width=128, height=128, max_depth=3, spp=1)
    # eager: a replay of the captured sample calls no gather_block
    _, seen = capture_fetches(lambda: eager_render(
        scene, mesh_scene_camera().to(dev), cfg))
    ids = [x for _, w, x in seen if w == sp.TRI_PACK_WIDTH][2]
    table = sp.build_tri_pack(scene)
    assert KP.fwd_path(*table.shape) == "in place"
    assert torch.equal(KP.gather_rows_t(table, ids),
                       KP.gather_rows_t_plain(table, ids))


def test_packgather_rejects_mixed_devices(dev):
    table = torch.zeros((4, 3), device=dev)
    with pytest.raises(ValueError):
        KP.gather_rows_t(table, torch.zeros(5, dtype=torch.int32))


def test_render_goes_through_the_kernels_only(dev):
    cfg = RenderConfig(width=32, height=32, max_depth=3, spp=2, seed=1)
    scene = builders.cornell_box()
    assert scene.device.type == "cuda"   # the builders' default
    img, ran = _ran(lambda: render(scene, Camera.make(**POSE), cfg))
    assert ran["intersect_dense"] > 0 and ran["gather_rows_t"] > 0
    assert ran["intersect_dense_plain"] == 0
    assert ran["gather_rows_t_plain"] == 0
    # the same render on the CPU: identical up to knife-edge pixels, where an
    # ULP of difference between the CPU's and the card's sin/cos/sqrt can
    # flip a decision
    ref = render(scene.to("cpu"), Camera.make(**POSE), cfg)
    d = (img.cpu() - ref).abs().amax(dim=-1)
    assert (d > 1e-3).float().mean() <= 0.005
    assert d[d <= 1e-3].mean() < 1e-4


@pytest.mark.parametrize("T,W,N", [(36, 55, 262_144), (2, 13, 1000),
                                   (588, 55, 100_000), (1000, 7, 77),
                                   (36, 55, 0), (1, 55, 5000),
                                   (255, 13, 2049), (256, 7, 513),
                                   (49_970, 55, 262_144),
                                   (65_536, 7, 300_000),
                                   (999_956, 55, 262_139)])
def test_packgather_bwd_kernel_matches_plain(dev, T, W, N):
    """Tables of one, two and three radix passes, lane counts that no block
    size divides, out-of-range ids, and bit-identical repeats."""
    rs = np.random.RandomState(T + N)
    idx = torch.tensor(rs.randint(-2, T + 2, N), dtype=torch.int32,
                       device=dev)
    cot = torch.tensor(rs.randn(W, N), dtype=torch.float32, device=dev)
    out = KP.gather_rows_t_bwd(idx, cot, T)
    assert out.shape == (T, W) and out.dtype == torch.float32
    assert torch.equal(out, KP.gather_rows_t_bwd(idx, cot, T))
    ok = (idx >= 0) & (idx < T)
    ref = torch.zeros((T, W), dtype=torch.float64, device=dev).index_add_(
        0, idx[ok].long(), cot.double().T[ok])
    torch.testing.assert_close(out.double(), ref, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(KP.gather_rows_t_bwd_plain(idx, cot, T), out,
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kind", ["one_row", "all_out", "heavy_row0",
                                  "sorted", "runs"])
@pytest.mark.parametrize("T,N", [(1, 70_001), (36, 262_144),
                                 (49_970, 262_139)])
def test_packgather_bwd_kernel_on_skewed_ids(dev, kind, T, N):
    """Rows that own every lane, half the lanes or none; coherent runs that
    span the kernel's chunks."""
    rs = np.random.RandomState(N + T)
    if kind == "one_row":
        idx = np.full(N, T // 2)
    elif kind == "all_out":
        idx = rs.choice([-1, T, T + 3], N)
    elif kind == "heavy_row0":
        idx = np.where(rs.uniform(size=N) < 0.5, 0, rs.randint(0, T, N))
    elif kind == "sorted":
        idx = np.sort(rs.randint(-1, T + 1, N))
    else:
        idx = np.repeat(rs.randint(0, T, N // 700 + 1), 700)[:N]
    W = 55
    idx = torch.tensor(idx, dtype=torch.int32, device=dev)
    cot = torch.tensor(rs.randn(W, N), dtype=torch.float32, device=dev)
    out = KP.gather_rows_t_bwd(idx, cot, T)
    assert torch.equal(out, KP.gather_rows_t_bwd(idx, cot, T))
    ok = (idx >= 0) & (idx < T)
    ref = torch.zeros((T, W), dtype=torch.float64, device=dev).index_add_(
        0, idx[ok].long(), cot.double().T[ok])
    torch.testing.assert_close(out.double(), ref, rtol=1e-6, atol=1e-5)
    touched = torch.zeros(T, dtype=torch.bool, device=dev)
    touched[idx[ok].long()] = True
    assert not out[~touched].any()


def test_cuda_backward_never_reaches_the_plain_version(dev, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CUDA backward took the plain version")
    monkeypatch.setattr(KP, "gather_rows_t_bwd_plain", refuse)
    table = torch.randn((36, 55), device=dev, requires_grad=True)
    idx = torch.randint(0, 36, (4096,), dtype=torch.int32, device=dev)
    _, ran = _ran(lambda: KP.gather_rows_t(table, idx).sum().backward())
    assert ran["gather_rows_t_bwd"] == 1
    counts = torch.bincount(idx.long(), minlength=36).float()
    torch.testing.assert_close(table.grad, counts[:, None].expand(36, 55),
                               rtol=0, atol=0)


def test_grad_render_goes_through_the_kernels_only(dev):
    cfg = RenderConfig(width=32, height=32, max_depth=3, spp=1, seed=1)
    scene = builders.cornell_box()
    cam = Camera.make(**POSE)
    (loss, grads), ran = _ran(lambda: grad_render(
        scene, cam, cfg, torch.zeros((32, 32, 3), device=dev)))
    assert ran["intersect_dense"] > 0 and ran["gather_rows_t"] > 0
    assert ran["gather_rows_t_bwd"] > 0
    assert ran["intersect_dense_plain"] == 0
    assert ran["gather_rows_t_plain"] == 0
    assert ran["gather_rows_t_bwd_plain"] == 0
    assert all(torch.isfinite(g).all() for g in grads.values())
    # the same gradients on the CPU, up to f32 round-off (knife-edge lanes
    # aside, none of which this image has measured)
    ref_loss, ref = grad_render(builders.cornell_box(device="cpu"), cam, cfg,
                                torch.zeros((32, 32, 3)))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * float(ref_loss)
    for k, g in ref.items():
        torch.testing.assert_close(grads[k].cpu(), g, rtol=1e-4, atol=1e-6)


# ---- K4, the BVH closest-hit kernel ----------------------------------------

def _scene_rays(seed, n, dev, lo=(-4, 0.5, 1.0), hi=(4, 2.5, 12.0)):
    rs = np.random.RandomState(seed)
    ro = rs.uniform(lo, hi, (n, 3))
    d = rs.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1]) - 1.0
    rd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t_lower = np.where(rs.uniform(size=n) < 0.3, rs.uniform(0, 2, n), 0.0)
    alive = rs.uniform(size=n) < 0.8
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.tensor(ro, **f32), torch.tensor(rd, **f32),
            torch.tensor(t_lower, **f32),
            torch.tensor(alive, dtype=torch.bool, device=dev))


def _k4_both(scene, ro, rd, t_lower, alive):
    accel = scene.accel
    out = KL.intersect_list(scene.geom, ro, rd, t_lower, alive, accel=accel)
    ref = KL.intersect_list_plain(scene.geom, ro, rd, t_lower, alive,
                                  None if accel is None else accel.perm)
    return out, ref


@pytest.mark.parametrize("accel", ["none", "always"])
@pytest.mark.parametrize("n", [1, 1000, 65_536])
def test_bvh_kernel_matches_plain_mesh_scene(dev, accel, n):
    scene = mesh_scene(3000, accel=accel)
    out, ref = _k4_both(scene, *_scene_rays(n, n, dev))
    _assert_same(out, ref)


def test_bvh_kernel_matches_plain_flat_plane_and_retrace(dev):
    """Rays down onto a flat quad above a flat plane, then re-traced past
    the quad with t_lower; rays parallel to the planes, their origins on
    the quad's plane (a flat box, rd.y = 0 on its slab plane)."""
    scene = flat_plane_scene(37).to(dev)
    n = 4096
    rs = np.random.RandomState(3)
    ro = np.stack([rs.uniform(-3, 3, n), np.full(n, 3.0),
                   rs.uniform(-3, 3, n)], axis=1)
    rd = np.tile([[0.0, -1.0, 0.0]], (n, 1))
    ro[1::2, 1] = 1.0   # on the quad's plane
    rd[1::4] = [0.6, 0.0, 0.8]  # parallel to the planes
    f32 = dict(dtype=torch.float32, device=dev)
    ro, rd = torch.tensor(ro, **f32), torch.tensor(rd, **f32)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    first, ref = _k4_both(scene, ro, rd, torch.zeros(n, **f32), alive)
    _assert_same(first, ref)
    down = torch.arange(n, device=dev) % 2 == 0
    assert bool(first[0][down].all()) and not first[0][1::4].any()
    assert torch.allclose(first[2][down], torch.full_like(first[2][down], 2.0))
    again, ref = _k4_both(scene, ro, rd, first[2], alive)   # past the quad
    _assert_same(again, ref)
    assert torch.allclose(again[2][down], torch.full_like(again[2][down], 3.0))


def test_bvh_kernel_ties_go_to_the_lowest_position(dev):
    """Every triangle twice: the lower scene id wins without a BVH, the
    lower BVH slot with one, on the card as in the plain version."""
    plane = flat_plane_scene(37, quad=False)
    g = plane.geom
    twice = pack_geometry({"v0": torch.cat([g.v0, g.v0]).numpy(),
                           "v1": torch.cat([g.v0 + g.e1] * 2).numpy(),
                           "v2": torch.cat([g.v0 + g.e2] * 2).numpy()})
    for accel in ("none", "always"):
        scene = finalize_scene(twice, plane.materials, accel=accel).to(dev)
        out, ref = _k4_both(scene, *_scene_rays(9, 8192, dev,
                                                lo=(-2, 1, -2), hi=(2, 3, 2)))
        _assert_same(out, ref)
        assert float(out[0].float().mean()) > 0.5


def test_bvh_kernel_caches_its_inputs_per_scene(dev):
    """The wide tree and the rows are built once per (geometry, BVH): again
    for another BVH of the same geometry, and afresh for a
    ``dataclasses.replace``d geometry."""
    scene = mesh_scene(3000, accel="none")
    ro, rd, t_lower, alive = _scene_rays(0, 256, dev)
    KL.intersect_list(scene.geom, ro, rd, t_lower, alive)
    prep = scene.geom._k4_prepared[1]
    first = KL.intersect_list(scene.geom, ro, rd, t_lower, alive)
    assert scene.geom._k4_prepared[1] is prep
    assert scene.accel is None and torch.equal(prep.pos, prep.perm)
    assert prep.nodes.is_cuda and prep.nodes.data_ptr() % 128 == 0
    assert prep.tris.data_ptr() % 16 == 0

    with_bvh = mesh_scene(3000, accel="always")
    KL.intersect_list(scene.geom, ro, rd, t_lower, alive,
                      accel=with_bvh.accel)
    assert scene.geom._k4_prepared[1] is not prep
    assert scene.geom._k4_prepared[1].pos is None

    moved = dataclasses.replace(scene.geom, v0=scene.geom.v0 + 0.25)
    out = KL.intersect_list(moved, ro, rd, t_lower, alive)
    assert moved._k4_prepared[1] is not scene.geom._k4_prepared[1]
    _assert_same(out, KL.intersect_list_plain(moved, ro, rd, t_lower, alive))
    assert not torch.equal(out[2], first[2])


@pytest.mark.parametrize("accel", ["none", "always"])
def test_bvh_kernel_matches_the_plain_walk_and_its_counting_twin(dev, accel):
    """The kernel, its counting twin and ``walk_plain`` on the same layout:
    the five outputs bit-equal among all three and with the brute-force
    plain version, and the twin's node and triangle counts equal to the
    plain walk's lane for lane."""
    scene = mesh_scene(3000, accel=accel)
    rays = _scene_rays(21, 4096, dev)
    out, ref = _k4_both(scene, *rays)
    _assert_same(out, ref)
    twin, ran = _ran(lambda: KL.intersect_list_stats(scene.geom, *rays,
                                                     accel=scene.accel))
    assert ran["intersect_list"] == 0   # not a render-path launch
    _assert_same(twin[:5], out)
    walk = KL.walk_plain(KL._prepare(scene.geom, scene.accel), *rays)
    _assert_same(walk[:5], out)
    _assert_same(walk[5:], twin[5:])
    alive = rays[3]
    assert not twin[5][~alive].any() and bool((twin[5][alive] >= 1).all())


def test_cuda_queries_never_reach_the_list_plain_version(dev, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CUDA query took the plain version")
    scene = mesh_scene(3000, accel="always")
    ro, rd, t_lower, alive = _scene_rays(1, 512, dev)
    monkeypatch.setattr(KL, "intersect_list_plain", refuse)
    _, ran = _ran(lambda: KL.intersect_list(scene.geom, ro, rd, t_lower,
                                            alive, accel=scene.accel))
    assert ran["intersect_list"] == 1


def test_large_scene_render_goes_through_k4_only(dev):
    cfg = RenderConfig(width=32, height=32, max_depth=3, spp=1, seed=1)
    scene = mesh_scene(6000)
    img, ran = _ran(lambda: render(scene, mesh_scene_camera(), cfg))
    assert ran["intersect_list"] > 0 and ran["gather_rows_t"] > 0
    assert ran["intersect_dense"] == 0
    assert ran["intersect_dense_plain"] == 0
    assert ran["intersect_list_plain"] == 0
    assert ran["gather_rows_t_plain"] == 0
    ref = render(scene.to("cpu"), mesh_scene_camera(), cfg)
    d = (img.cpu() - ref).abs().amax(dim=-1)
    assert (d > 1e-3).float().mean() <= 0.005
    assert d[d <= 1e-3].mean() < 1e-4


@pytest.mark.parametrize("mode,order", [("sort", "scan"), ("gather", "scan"),
                                        ("off", "block"), ("sort", "block")])
def test_reordered_renders_are_bit_identical_on_the_card(dev, mode, order):
    scene = mesh_scene(6000)
    kw = dict(width=64, height=48, max_depth=3, spp=1, seed=2)
    ref = render(scene, mesh_scene_camera(), RenderConfig(
        compact_wavefront="off", pixel_order="scan", **kw))
    img = render(scene, mesh_scene_camera(), RenderConfig(
        compact_wavefront=mode, pixel_order=order, **kw))
    assert torch.equal(img, ref)


# ---- the application path on the card --------------------------------------

@pytest.mark.parametrize("big", [False, True])
def test_session_pause_resume_and_checkpoint_are_bit_exact(dev, tmp_path,
                                                           big):
    """Pause and resume, a checkpoint into a fresh session and the
    background thread give the uninterrupted session's accumulation bit for
    bit, through K1 (Cornell) or K4 (3,000 triangles), never a plain
    version."""
    from pbrpathtracer_tpu_torch import RenderSession, RenderState
    scene = mesh_scene(3000) if big else builders.cornell_box()
    cam = (mesh_scene_camera() if big else Camera.make(**POSE)).to(dev)
    cfg = RenderConfig(width=64, height=64, max_depth=3, seed=5)

    def session():
        return RenderSession(scene=scene, camera=cam, cfg=cfg)

    def sessions():
        a = session()
        a.start()
        assert a.step(2) == 2
        a.save_checkpoint(str(tmp_path / "s.npz"))
        a.pause()
        assert a.step(3) == 0
        a.resume()
        a.step(2)
        b = session()
        b.start()
        b.step(4)
        assert a.accum.is_cuda and torch.equal(a.accum, b.accum)
        c = session()
        c.load_checkpoint(str(tmp_path / "s.npz"))
        c.step(2)
        assert torch.equal(c.accum, b.accum)
        d = session()
        d.target_samples = 4
        d.run_async()
        assert d.wait(timeout=120) and d.state == RenderState.PAUSED
        assert torch.equal(d.accum, b.accum)
        return b
    b, ran = _ran(sessions)
    route, other = (("intersect_list", "intersect_dense") if big
                    else ("intersect_dense", "intersect_list"))
    assert ran[route] > 0 and ran["gather_rows_t"] > 0 and ran[other] == 0
    assert all(v == 0 for k, v in ran.items() if k.endswith("_plain"))
    assert np.array_equal(b.image_u8(),
                          (np.clip(b.image(), 0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("name", ["translucent", "cornell", "mesh3k"])
def test_preview_on_the_card_equals_the_cpu(dev, name):
    """The preview through K1 (five layers on the translucent scene) and
    through K4: ids identical to the same call on the CPU, colour allclose
    at 1e-5 on all but the knife-edge pixels that an ulp in a ray decides
    (a second layer where the glass box's bottom and the floor share a
    plane, where the JAX package's two CPU intersectors differ too; a
    texel border of the terrain): 0.5% of the pixels."""
    from pbrpathtracer_tpu_torch import pick, preview_render
    scene = {"translucent": builders.translucent_scene,
             "cornell": builders.cornell_box,
             "mesh3k": lambda: mesh_scene(3000)}[name]()
    cam = (mesh_scene_camera() if name == "mesh3k"
           else Camera.make(**POSE)).to(dev)
    (color, oid, eid), ran = _ran(
        lambda: preview_render(scene, cam, 96, 96, selected=(0, 1)))
    expect = {"translucent": ("intersect_dense", 5),
              "cornell": ("intersect_dense", 1),
              "mesh3k": ("intersect_list", 1)}[name]
    assert ran[expect[0]] == expect[1]
    assert all(v == 0 for k, v in ran.items() if k.endswith("_plain"))
    assert color.is_cuda and oid.dtype == torch.int32
    ref = preview_render(scene.to("cpu"), cam.to("cpu"), 96, 96,
                         selected=(0, 1))
    assert torch.equal(oid.cpu(), ref[1]) and torch.equal(eid.cpu(), ref[2])
    off = ~torch.isclose(color.cpu(), ref[0], rtol=1e-5, atol=1e-5).all(-1)
    budget = {"translucent": 0.005, "cornell": 0.0, "mesh3k": 0.005}[name]
    assert float(off.float().mean()) <= budget
    assert pick(oid, eid, 48, 90) == pick(ref[1], ref[2], 48, 90)
    if name == "mesh3k":
        assert bool((oid == -1).any()) and not bool(color[oid == -1].any())


def test_ggx_gradients_are_finite_on_the_card(dev):
    scene = builders.cornell_spheres_scene()
    cam = Camera.make(**POSE).to(dev)
    cfg = RenderConfig(width=96, height=96, max_depth=4, spp=2, seed=2,
                       brdf="ggx")
    img = render(scene, cam, cfg)
    assert bool(torch.isfinite(img).all())
    assert not torch.equal(img, render(scene, cam,
                                       cfg.replace(brdf="reference")))
    loss, grads = grad_render(scene, cam, cfg, torch.zeros_like(img))
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["mat.roughness"][6:].abs().min()) > 0


def test_editor_scene_and_cli_default_to_the_card(dev, tmp_path):
    """OBJ -> editor -> .pts -> the CLI, with no device named anywhere: the
    scene lies on the card and the render goes through the kernels."""
    from pbrpathtracer_tpu_torch import (EditorScene, MaterialSpec, cli,
                                         render_pts, save_pts)
    from pbrpathtracer_tpu_torch.io.png import read_png
    from pbrpathtracer_tpu_torch.scene.obj_export import export_scene_obj
    obj = export_scene_obj(str(tmp_path / "box.obj"), builders.cornell_box())
    ed = EditorScene()
    assert ed.load_object(obj)
    ed.set_material(0, 3, MaterialSpec(emissive=(1, 1, 1),
                                       emissive_intensity=2.0))
    ed.set_camera(POSE["pos"])
    scene = ed.build_scene()
    assert scene.device.type == "cuda" and scene.num_lights == 2
    assert ed.tracer_camera().pos.is_cuda
    pts = str(tmp_path / "box.pts")
    save_pts(pts, ed, {"trace_depth": 2, "width": 64, "height": 64})
    out = str(tmp_path / "box.png")

    def both():
        img, _, _ = render_pts(pts, spp=2)
        assert img.is_cuda and float(img.max()) > 0.1
        cli.main(["render", pts, "-o", out, "--spp", "2"])
    _, ran = _ran(both)
    assert ran["intersect_dense"] > 0
    assert ran["intersect_dense_plain"] == 0
    assert read_png(out).shape == (64, 64, 4)


# ---- the sharded layers and the hit_vjp modes --------------------------------

@pytest.mark.parametrize("T,N", [(36, 262_144), (2986, 1000),
                                 (49_970, 262_144), (999_956, 65_536)])
def test_packgather_kernel_matches_plain_at_width_9(dev, T, N):
    """The (v0, e1, e2) table that the "winner" backward fetches from."""
    rs = np.random.RandomState(T)
    table = torch.tensor(rs.normal(size=(T, 9)), dtype=torch.float32,
                         device=dev)
    idx = rs.randint(-2, T + 2, N)
    idx[::3] = rs.randint(0, min(T, 64), idx[::3].shape[0])   # coherent runs
    idx = torch.tensor(idx, dtype=torch.int32, device=dev)
    assert torch.equal(KP.gather_rows_t(table, idx),
                       KP.gather_rows_t_plain(table, idx))


def _plain_intersector(scene, ro, rd, t_lower, alive=None):
    if KI.dense_chunks(scene.num_triangles) > KI.MAX_DENSE_CHUNKS:
        perm = None if scene.accel is None else scene.accel.perm
        return KL.intersect_list_plain(scene.geom, ro, rd, t_lower, alive,
                                       perm)
    perm = None if scene.accel is None else scene.accel.perm
    return KI.intersect_dense_plain(scene.geom, ro, rd, t_lower, alive, perm)


@pytest.mark.parametrize("route", ["K1", "K4"])
def test_custom_vjp_over_the_kernels_equals_it_over_the_plain_versions(
        dev, route):
    """``with_custom_vjp`` over K1 and over K4 against the same Function
    over their plain versions: the same outputs bit for bit, and the same
    d_ro, d_rd (the winner's rows come through K2 either way)."""
    from pbrpathtracer_tpu_torch.ops.hit import default_intersector
    from pbrpathtracer_tpu_torch.ops.intersect_vjp import with_custom_vjp
    if route == "K1":
        scene, rays = builders.translucent_scene(), _rays(5, 20_000, dev)
    else:
        scene, rays = mesh_scene(3000), _scene_rays(5, 20_000, dev)
    ro, rd, t_lower, alive = rays
    cots = torch.tensor(np.random.RandomState(1).normal(size=(3, 20_000)),
                        dtype=torch.float32, device=dev)
    out = {}
    counters = {"K1": "intersect_dense", "K4": "intersect_list"}
    for name, fn in (("kernel", default_intersector),
                     ("plain", _plain_intersector)):
        a = ro.clone().requires_grad_(True)
        b = rd.clone().requires_grad_(True)

        def query_and_grads():
            hit, idx, t, u, v = with_custom_vjp(fn)(scene, a, b, t_lower,
                                                    alive=alive)
            loss = (t * cots[0] + u * cots[1] + v * cots[2]).sum()
            return (hit, idx, t, u, v), torch.autograd.grad(loss, [a, b])
        ((hit, idx, t, u, v), grads), ran = _ran(query_and_grads)
        launched = (ran[counters[route]], ran["gather_rows_t"])
        assert launched == ((1, 1) if name == "kernel" else (0, 1))
        out[name] = (hit, idx, t, u, v, *grads)
    _assert_same(out["kernel"], out["plain"])
    assert float(out["kernel"][5].abs().max()) > 0


@pytest.mark.parametrize("mode", ["winner", "autodiff"])
def test_hit_vjp_modes_give_the_recompute_gradients_on_the_card(dev, mode):
    scene = builders.translucent_scene()
    cam = Camera.make(**POSE, focal_dist=2.2, aperture=0.04).to(dev)
    cfg = RenderConfig(width=32, height=32, max_depth=3, spp=2, seed=3)
    target = render(scene, cam, cfg) * 0.8
    ref_loss, ref = grad_render(scene, cam, cfg, target, camera_lens=True)
    (loss, grads), ran = _ran(lambda: grad_render(
        scene, cam, cfg.replace(hit_vjp=mode), target, camera_lens=True))
    assert ran["intersect_dense_plain"] == ran["gather_rows_t_plain"] == 0
    assert float(loss) == float(ref_loss)
    for k in ref:
        torch.testing.assert_close(grads[k], ref[k], rtol=1e-4, atol=1e-8)


def test_sharded_render_and_step_on_the_card_without_a_group(dev):
    """The one-process mesh on the card: ``render_sharded`` equals
    ``render`` bit for bit, and a fused step goes through K1, K2 and K3."""
    import functools
    from pbrpathtracer_tpu_torch import get_params
    from pbrpathtracer_tpu_torch.parallel.mesh import (broadcast_params,
                                                       make_mesh)
    from pbrpathtracer_tpu_torch.parallel.render import (make_train_step,
                                                         render_sharded)
    scene = builders.cornell_box()
    cam = Camera.make(**POSE).to(dev)
    cfg = RenderConfig(width=64, height=64, max_depth=3, spp=2, seed=4)
    mesh = make_mesh()
    assert mesh.device == scene.device and mesh.world_size == 1
    assert torch.equal(render_sharded(scene, cam, cfg, mesh=mesh),
                       render(scene, cam, cfg))
    params = broadcast_params(get_params(scene, cam), mesh)
    step = make_train_step(scene, cam, cfg,
                           functools.partial(torch.optim.Adam, lr=1e-2), mesh)
    loss, ran = _ran(lambda: step(
        params, torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev),
        torch.zeros((cfg.num_pixels, 3), device=dev), 0))
    assert torch.isfinite(loss)
    assert all(ran[k] > 0 for k in ("intersect_dense", "gather_rows_t",
                                    "gather_rows_t_bwd"))


# ---- the compiled forward: captured samples against the eager render -------

def _compiled_case(name, dev):
    kw = dict(width=64, height=64, max_depth=3, spp=2, seed=3)
    if name == "cornell":
        return builders.cornell_box(), Camera.make(**POSE).to(dev), \
            RenderConfig(**kw)
    if name == "translucent":
        return (builders.translucent_scene(),
                Camera.make(**POSE, focal_dist=2.2, aperture=0.04).to(dev),
                RenderConfig(**{**kw, "max_depth": 5}))
    scene = mesh_scene(3000)    # over 2048 triangles: K4
    cfg = RenderConfig(**kw)
    if name == "mesh3k sort block":
        cfg = cfg.replace(compact_wavefront="sort", pixel_order="block")
    return scene, mesh_scene_camera().to(dev), cfg


@pytest.mark.parametrize("name", ["cornell", "mesh3k", "translucent",
                                  "mesh3k sort block"])
def test_compiled_render_equals_eager_bit_for_bit(dev, name):
    from pbrpathtracer_tpu_torch.engine.compiled import SAMPLES
    scene, cam, cfg = _compiled_case(name, dev)
    eager = eager_render(scene, cam, cfg)
    first = render(scene, cam, cfg)        # eager, then warm-up and capture
    captures = SAMPLES.captures
    again = render(scene, cam, cfg)        # replays only
    other = cfg.replace(seed=cfg.seed + 1)
    moved = render(scene, cam, other)      # a new seed: the same graphs
    assert SAMPLES.captures == captures
    assert SAMPLES.entry(scene, cam, cfg) is SAMPLES.entry(scene, cam, other)
    assert torch.equal(first, eager) and torch.equal(again, eager)
    assert torch.equal(moved, eager_render(scene, cam, other))
    assert not torch.equal(moved, eager)


def test_a_one_shot_render_captures_nothing(dev):
    """The first sample of a key renders eagerly and captures nothing; the
    second captures; a dropped scene takes its graphs with it."""
    import gc
    import weakref
    from pbrpathtracer_tpu_torch.engine.compiled import SAMPLES
    scene, cam, cfg = _compiled_case("cornell", dev)
    one = cfg.replace(spp=1)
    captures = SAMPLES.captures
    img = render(scene, cam, one)
    assert SAMPLES.captures == captures
    assert SAMPLES.entry(scene, cam, one) is None
    assert torch.equal(img, eager_render(scene, cam, one))
    assert torch.equal(render(scene, cam, one), img)   # captured here
    assert SAMPLES.captures == captures + 1
    entry = weakref.ref(SAMPLES.entry(scene, cam, one))
    held = len(SAMPLES)
    del scene
    gc.collect()
    assert entry() is None and len(SAMPLES) == held - 1


def test_compiled_results_are_fresh_tensors(dev):
    from pbrpathtracer_tpu_torch.engine.compiled import SAMPLES
    scene, cam, cfg = _compiled_case("cornell", dev)
    a = render(scene, cam, cfg)
    kept = a.clone()
    b = render(scene, cam, cfg.replace(seed=cfg.seed + 7))
    torch.cuda.synchronize()
    assert torch.equal(a, kept) and not torch.equal(a, b)
    r0 = SAMPLES.sample(scene, cam, cfg, 0)
    r0_kept = r0.clone()
    r1 = SAMPLES.sample(scene, cam, cfg, 1)
    torch.cuda.synchronize()
    assert torch.equal(r0, r0_kept) and not torch.equal(r0, r1)
    entry = SAMPLES.entry(scene, cam, cfg)
    buffers = {state.radiance.data_ptr() for state, _, _ in entry.outputs}
    assert r0.data_ptr() not in buffers and r1.data_ptr() not in buffers


def test_compiled_counters_advance_by_the_captured_launches(dev):
    from pbrpathtracer_tpu_torch.engine.compiled import SAMPLES
    for name in ("cornell", "mesh3k"):
        scene, cam, cfg = _compiled_case(name, dev)
        one = cfg.replace(spp=1)
        render(scene, cam, one)                     # eager
        render(scene, cam, one)                     # captured here
        entry = SAMPLES.entry(scene, cam, one)
        assert len(entry.graphs) == entry.n_segments + 1
        _, eager = _ran(lambda: eager_render(scene, cam, one))
        _, replay = _ran(lambda: render(scene, cam, one))
        assert replay == eager
        route = "intersect_list" if name == "mesh3k" else "intersect_dense"
        assert replay[route] > 0 and replay["gather_rows_t"] > 0
        assert all(n == 0 for k, n in replay.items() if k.endswith("_plain"))
        # the counts are those of the graphs replayed: a prefix of them
        prefixes = [_launches(sum((g.counts for g in entry.spans[:k]),
                                  collections.Counter()))
                    for k in range(1, len(entry.graphs) + 1)]
        assert replay in prefixes


def test_a_captured_session_builds_its_packs_in_the_prologue(dev):
    """A captured session key builds the shading packs in its prologue
    graph, and its segment graphs only read them: the material join's K2
    launch, the only K2 launch of a prologue, is the prologue graph's, and
    each segment graph launches K2 for its two fetches alone (the tri pack
    and the light pack; three while each segment built its tri pack). The
    entry holds the packs, so replays with other allocations and another
    key's capture between them equal the eager passes bit for bit, and a
    traced replay counts two pack builds a pass."""
    from pbrpathtracer_tpu_torch.engine.compiled import SAMPLES
    from pbrpathtracer_tpu_torch.engine.session import RenderSession
    scene, cam, cfg = _compiled_case("cornell", dev)
    cfg = cfg.replace(spp=1)
    s = RenderSession(scene=scene, camera=cam, cfg=cfg, device=dev)
    s.start()
    s.step(2)                                   # eager, then captured
    entry = SAMPLES.entry(scene, cam, cfg)
    assert entry is not None and entry.packs.uv_opacity is None
    assert entry.spans[0].counts["gather_rows_t"] == 1
    assert [g.counts["gather_rows_t"] for g in entry.spans[1:]] == \
        [2] * entry.n_segments
    held = []
    other, other_cam, other_cfg = _compiled_case("translucent", dev)
    for k in range(2):
        held.append(torch.randn(1 << 22, device=dev))
        render(other, other_cam, other_cfg.replace(spp=1))  # eager, capture
        held.append(torch.ones(1 << 21, device=dev))
        s.step(1)
    with obs.tracing():
        s.step(2)
    counts = obs.last_record()["counts"]
    assert counts["pack_builds"] == 4 and counts["graph_launches"] > 2
    accum = torch.zeros_like(s.accum)
    with torch.inference_mode():
        for k in range(6):
            accum = accum + render_sample(scene, cam, cfg, k)
    assert s.samples == 6 and torch.equal(s.accum, accum)


def test_compiled_session_with_concurrent_reads(dev):
    """A run_async session captures on its thread while this one reads the
    image; it ends where step() ends, bit for bit."""
    from pbrpathtracer_tpu_torch import RenderSession, RenderState
    scene = builders.cornell_box()         # a fresh key: captured below
    cam = Camera.make(**POSE).to(dev)
    cfg = RenderConfig(width=64, height=64, max_depth=3, seed=8)
    a = RenderSession(scene=scene, camera=cam, cfg=cfg)
    a.target_samples = 6
    a.run_async()
    reads = 0
    deadline = time.time() + 120
    while a._thread is not None and a._thread.is_alive() \
            and time.time() < deadline:
        img = a.image()
        assert img.shape == (64, 64, 3) and np.isfinite(img).all()
        reads += 1
    assert a.wait(timeout=1) and a.state == RenderState.PAUSED
    assert a.samples == 6 and reads > 0
    accum = torch.zeros_like(a.accum)
    with torch.inference_mode():
        for k in range(6):
            accum = accum + render_sample(scene, cam, cfg, k)
    assert torch.equal(a.accum, accum)


def test_a_failed_capture_raises(dev, monkeypatch):
    """A host read-back inside a segment: the eager samples take it, the
    capture (at the second sample) cannot; the render raises and caches
    nothing, and the next render without it captures."""
    from pbrpathtracer_tpu_torch.engine.compiled import SAMPLES
    from pbrpathtracer_tpu_torch.ops import integrator as pint
    from pbrpathtracer_tpu_torch.utils.roofline import record_launches
    scene, cam, cfg = _compiled_case("cornell", dev)
    shade = pint.shade_segment

    def reads_back(*args, **kwargs):
        out = shade(*args, **kwargs)
        float(out.radiance.sum())
        return out
    monkeypatch.setattr(pint, "shade_segment", reads_back)
    captures = SAMPLES.captures
    with pytest.raises(RuntimeError):
        render(scene, cam, cfg)
    assert SAMPLES.captures == captures
    assert SAMPLES.entry(scene, cam, cfg) is None
    monkeypatch.setattr(pint, "shade_segment", shade)
    assert torch.equal(render(scene, cam, cfg),
                       eager_render(scene, cam, cfg))
    assert SAMPLES.captures == captures + 1
    with record_launches(), pytest.raises(RuntimeError):
        render(scene, cam, cfg)             # a replay records no shapes


# ---- the compiled fwd+bwd: a captured fwd+bwd against the eager one ---------

LENS = dict(focal_dist=2.2, aperture=0.04)
GRAD_MODES = {"remat off": dict(remat_segments="off"),
              "remat hits": dict(remat_segments="hits"),
              "remat all": dict(remat_segments="all"),
              "winner": dict(hit_vjp="winner"),
              "autodiff": dict(hit_vjp="autodiff")}


def _eager_grad(scene, cam, cfg, target, seed=None, **select):
    from pbrpathtracer_tpu_torch import get_params
    from pbrpathtracer_tpu_torch.diff.loss import eager_loss_and_grad
    return eager_loss_and_grad(get_params(scene, cam, **select), scene, cam,
                               cfg, target, seed)


def _same_grad(a, b):
    (la, ga), (lb, gb) = a, b
    return torch.equal(la, lb) and list(ga) == list(gb) and all(
        torch.equal(ga[k], gb[k]) for k in ga)


@pytest.mark.parametrize("mode", list(GRAD_MODES))
def test_compiled_grad_equals_eager_bit_for_bit(dev, mode):
    """The first call of a key is eager, the second captures, later ones
    replay: each, and a replay at a new seed, equal the eager fwd+bwd in
    the loss and every gradient (materials and lens)."""
    from pbrpathtracer_tpu_torch.engine.compiled import GRADS
    scene = builders.cornell_box()
    cam = Camera.make(**POSE, **LENS).to(dev)
    cfg = RenderConfig(width=32, height=32, max_depth=3, spp=2, seed=1,
                       **GRAD_MODES[mode])
    target = torch.full((32, 32, 3), 0.2, device=dev)
    sel = dict(materials=True, camera_lens=True)
    eager = _eager_grad(scene, cam, cfg, target, **sel)
    captures = GRADS.captures
    first = grad_render(scene, cam, cfg, target, **sel)
    assert GRADS.captures == captures
    second = grad_render(scene, cam, cfg, target, **sel)   # captured here
    third = grad_render(scene, cam, cfg, target, **sel)
    moved = grad_render(scene, cam, cfg, target, seed=cfg.seed + 1, **sel)
    assert GRADS.captures == captures + 1
    assert all(_same_grad(x, eager) for x in (first, second, third))
    assert _same_grad(moved, _eager_grad(scene, cam, cfg, target,
                                         seed=cfg.seed + 1, **sel))
    assert not torch.equal(moved[0], eager[0])


@pytest.mark.parametrize("name", ["cornell", "mesh3k"])
def test_compiled_grad_launches_equal_eager(dev, name):
    """K1 or K4, K2 and K3 by replay, counted as the graph launched them:
    what the eager fwd+bwd launches."""
    scene, cam, cfg = _compiled_case(name, dev)
    cfg = cfg.replace(spp=1)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    grad_render(scene, cam, cfg, target)
    grad_render(scene, cam, cfg, target)      # captured here
    counts = {}
    for key, fn in (("eager", _eager_grad), ("replay", grad_render)):
        _, counts[key] = _ran(lambda: fn(scene, cam, cfg, target))
    assert counts["replay"] == counts["eager"]
    route = "intersect_list" if name == "mesh3k" else "intersect_dense"
    for k in (route, "gather_rows_t", "gather_rows_t_bwd"):
        assert counts["replay"][k] > 0
    assert all(n == 0 for k, n in counts["replay"].items()
               if k.endswith("_plain"))


def test_compiled_grad_regrows_on_the_translucent_scene(dev):
    """Captured at a seed whose samples run fewer segments than another
    seed's: the replay at that seed finds a lane alive after its captured
    segments, captures again with the larger counts and returns the eager
    result; the first seed then replays through dead segments, bit-equal."""
    from pbrpathtracer_tpu_torch import get_params
    from pbrpathtracer_tpu_torch.diff.loss import fwd_bwd
    from pbrpathtracer_tpu_torch.engine.compiled import GRADS
    scene = builders.translucent_scene()
    cam = Camera.make(**POSE, **LENS).to(dev)
    cfg = RenderConfig(width=12, height=10, max_depth=3, spp=2,
                       max_segments=16)
    target = torch.zeros((10, 12, 3), device=dev)
    params = get_params(scene, cam)
    runs = {}
    for s in range(6):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        runs[s] = fwd_bwd(leaves, scene, cam, cfg, target, s)[2]
    lo, hi = next((a, b) for a in runs for b in runs
                  if any(x > y for x, y in zip(runs[b], runs[a])))
    grad_render(scene, cam, cfg, target, seed=lo)
    captures = GRADS.captures
    grad_render(scene, cam, cfg, target, seed=lo)      # captured here
    entry = GRADS.entry(params, scene, cam, cfg, target)
    assert entry.counts == runs[lo] and GRADS.captures == captures + 1
    grown = grad_render(scene, cam, cfg, target, seed=hi)
    assert GRADS.captures == captures + 2
    assert entry.counts == [max(a, b) for a, b in zip(runs[lo], runs[hi])]
    assert _same_grad(grown, _eager_grad(scene, cam, cfg, target, seed=hi))
    for s in (hi, lo):
        assert _same_grad(grad_render(scene, cam, cfg, target, seed=s),
                          _eager_grad(scene, cam, cfg, target, seed=s))
    assert GRADS.captures == captures + 2


def test_compiled_fit_equals_the_eager_fit_and_resumes(dev, tmp_path,
                                                       monkeypatch):
    """The fit's steps replay the captured fwd+bwd (Adam and the clip
    eager): its losses and final parameters are the eager fit's bit for
    bit, and under deterministic algorithms a 3+3 resume equals 6 steps."""
    from pbrpathtracer_tpu_torch import fit
    from pbrpathtracer_tpu_torch.diff import fit as fit_module
    from pbrpathtracer_tpu_torch.diff.loss import eager_loss_and_grad
    from pbrpathtracer_tpu_torch.engine.compiled import GRADS
    scene, cam = builders.cornell_box(), Camera.make(**POSE).to(dev)
    cfg = RenderConfig(width=32, height=32, max_depth=2, spp=2, seed=3)
    target = torch.zeros((32, 32, 3), device=dev)
    captures = GRADS.captures
    compiled = fit(scene, cam, cfg, target, steps=5, lr=3e-2)
    assert GRADS.captures == captures + 1
    with monkeypatch.context() as m:
        m.setattr(fit_module, "loss_and_grad", eager_loss_and_grad)
        eager = fit(scene, cam, cfg, target, steps=5, lr=3e-2)
    assert compiled.losses == eager.losses
    assert all(torch.equal(compiled.params[k], eager.params[k])
               for k in eager.params)
    ckpt = str(tmp_path / "fit.npz")
    torch.use_deterministic_algorithms(True)
    try:
        full = fit(scene, cam, cfg, target, steps=6, lr=3e-2)
        fit(scene, cam, cfg, target, steps=3, lr=3e-2, checkpoint_path=ckpt,
            checkpoint_every=3)
        resumed = fit(scene, cam, cfg, target, steps=6, lr=3e-2,
                      checkpoint_path=ckpt, resume=True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed.losses == full.losses
    assert all(torch.equal(full.params[k], resumed.params[k])
               for k in full.params)


def test_a_dropped_scene_frees_its_gradient_entry(dev):
    import gc
    import weakref
    from pbrpathtracer_tpu_torch import get_params
    from pbrpathtracer_tpu_torch.engine.compiled import GRADS
    scene, cam, cfg = _compiled_case("cornell", dev)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    grad_render(scene, cam, cfg, target)
    grad_render(scene, cam, cfg, target)      # captured here
    entry = weakref.ref(GRADS.entry(get_params(scene, cam), scene, cam, cfg,
                                    target))
    held = len(GRADS)
    del scene
    gc.collect()
    assert entry() is None and len(GRADS) == held - 1


def test_a_failed_gradient_capture_raises(dev, monkeypatch):
    """A host read-back inside a segment: the eager call takes it, the
    capture cannot; the call raises and caches no graph, and the next call
    without it captures."""
    from pbrpathtracer_tpu_torch import get_params
    from pbrpathtracer_tpu_torch.engine.compiled import GRADS
    from pbrpathtracer_tpu_torch.ops import integrator as pint
    from pbrpathtracer_tpu_torch.utils.roofline import record_launches
    scene, cam, cfg = _compiled_case("cornell", dev)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    shade = pint.shade_segment

    def reads_back(*args, **kwargs):
        out = shade(*args, **kwargs)
        float(out.radiance.sum())
        return out
    monkeypatch.setattr(pint, "shade_segment", reads_back)
    grad_render(scene, cam, cfg, target)      # eager: the key noted
    captures = GRADS.captures
    with pytest.raises(RuntimeError):
        grad_render(scene, cam, cfg, target)
    assert GRADS.captures == captures
    assert GRADS.entry(get_params(scene, cam), scene, cam, cfg,
                       target) is None
    monkeypatch.setattr(pint, "shade_segment", shade)
    assert _same_grad(grad_render(scene, cam, cfg, target),
                      _eager_grad(scene, cam, cfg, target))
    assert GRADS.captures == captures + 1
    with record_launches(), pytest.raises(RuntimeError):
        grad_render(scene, cam, cfg, target)   # a replay records no shapes


# ---- the compiled sharded entries: replays with the collectives between ------

def _sharded_steps(dev, make, cfg, async_op=None):
    """(eager(seed), compiled(seed)) of one train step made twice from the
    same start on the one-process mesh: each call returns the loss, the
    gradients its update saw and the parameters after it."""
    from chip_smoke import capture_sgd
    from pbrpathtracer_tpu_torch import get_params
    from pbrpathtracer_tpu_torch.parallel.mesh import (broadcast_params,
                                                       make_mesh)
    scene, cam = builders.cornell_box(), Camera.make(**POSE).to(dev)
    mesh = make_mesh()
    pix = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
    target = torch.full((cfg.num_pixels, 3), 0.2, device=dev)

    def way(eager):
        params = broadcast_params(get_params(scene, cam), mesh)
        step = make(scene, cam, cfg, capture_sgd(1e-2), mesh)
        if async_op is not None:
            step.async_op = async_op
        call = step.eager if eager else step

        def run(seed):
            loss = call(params, pix, target, seed)
            return [loss.clone(), *step.optimizer.seen,
                    *(params[k].detach().clone() for k in sorted(params))]
        return run
    return way(True), way(False)


def test_compiled_render_sharded_equals_eager(dev):
    """``render_sharded`` replays captured samples over its shard, a fresh
    shard tensor at every call under one key; the four shards of a world of
    four replay one key with their own lanes."""
    from pbrpathtracer_tpu_torch.engine.compiled import SAMPLES
    from pbrpathtracer_tpu_torch.parallel.mesh import (Mesh, local_shard,
                                                       make_mesh)
    from pbrpathtracer_tpu_torch.parallel.render import (
        eager_render_local, eager_render_sharded, render_local,
        render_sharded)
    for name in ("cornell", "mesh3k sort block"):
        scene, cam, cfg = _compiled_case(name, dev)
        mesh = make_mesh()
        eager = eager_render_sharded(scene, cam, cfg, mesh=mesh)
        assert torch.equal(eager, eager_render(scene, cam, cfg))
        captures = SAMPLES.captures
        for _ in range(3):
            assert torch.equal(render_sharded(scene, cam, cfg, mesh=mesh),
                               eager)
        assert SAMPLES.captures == captures + 1
        pix = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
        for r in range(4):
            shard = local_shard(pix, Mesh(None, r, 4, dev))
            assert torch.equal(render_local(scene, cam, cfg, shard),
                               eager_render_local(scene, cam, cfg, shard))
        assert SAMPLES.captures == captures + 2


@pytest.mark.parametrize("kind", ["fused spp 1", "fused spp 2",
                                  "overlapped async", "overlapped sync"])
def test_compiled_steps_equal_the_eager_steps(dev, kind):
    """The first call of a step's keys is eager, the second captures, later
    ones replay; at each, and at a new seed, the loss, the gradients the
    update saw and the parameters after it equal the eager step's bit for
    bit, with the same launches and all-reduces."""
    from pbrpathtracer_tpu_torch.engine.compiled import FUSED, SAMPLES, VJPS
    from pbrpathtracer_tpu_torch.parallel.render import (
        make_train_step, make_train_step_overlapped)
    over = kind.startswith("overlapped")
    cfg = RenderConfig(width=32, height=32, max_depth=3,
                       spp=1 if kind == "fused spp 1" else 2, seed=2)
    eager, compiled = _sharded_steps(
        dev, make_train_step_overlapped if over else make_train_step, cfg,
        None if not over else kind.endswith("async"))
    caches = (SAMPLES, FUSED, VJPS)
    counted = {}
    for i, seed in enumerate((0, 0, 0, 5)):
        got = {}
        for key, fn in (("eager", eager), ("compiled", compiled)):
            got[key], moved = obs.counted(lambda: fn(seed))
            torch.cuda.synchronize()
            counted[key] = (_launches(moved), moved.get("all_reduces", 0))
        assert all(torch.equal(a, b)
                   for a, b in zip(got["eager"], got["compiled"])), (i, seed)
        if i == 1:
            captures = sum(c.captures for c in caches)
        if i >= 2:     # replays
            assert counted["compiled"] == counted["eager"]
    assert counted["eager"][1] == (cfg.spp + 1 if over else 1)
    assert sum(c.captures for c in caches) == captures


def test_a_failed_step_capture_raises(dev, monkeypatch):
    """A host read-back inside a segment: the fused step's eager first call
    takes it, its capture cannot; the step raises before its all-reduce
    and update, and caches no graph."""
    from pbrpathtracer_tpu_torch.engine.compiled import FUSED
    from pbrpathtracer_tpu_torch.ops import integrator as pint
    from pbrpathtracer_tpu_torch.parallel.render import make_train_step
    cfg = RenderConfig(width=32, height=32, max_depth=2, spp=1, seed=2)
    _, compiled = _sharded_steps(dev, make_train_step, cfg)
    shade = pint.shade_segment

    def reads_back(*args, **kwargs):
        out = shade(*args, **kwargs)
        float(out.radiance.sum())
        return out
    monkeypatch.setattr(pint, "shade_segment", reads_back)
    compiled(0)                               # eager: the key noted
    captures, held = FUSED.captures, len(FUSED)

    def refused():
        with pytest.raises(RuntimeError):
            compiled(0)
    _, moved = obs.counted(refused)
    assert FUSED.captures == captures and "all_reduces" not in moved
    assert len(FUSED) == held


# ---- the texture read and the material join through K2/K3 --------------------

def _f64_sums(rows, cot, n_rows):
    """f64 sums of the rows of ``cot`` [N, W] per id ``rows`` [N]; ids outside
    [0, n_rows) dropped."""
    ok = (rows >= 0) & (rows < n_rows)
    return torch.zeros((n_rows, cot.shape[1]), dtype=torch.float64,
                       device=cot.device).index_add_(
        0, rows[ok].long(), cot[ok].double())


@pytest.mark.parametrize("case", ["texture uniform", "texture one texel",
                                  "materials 50k"])
def test_texture_and_material_gradients_are_k3_sums(dev, case):
    """The texture read's gradient w.r.t. the texels and the material join's
    w.r.t. the material leaves are one K3 call each: within 1e-6 of an f64
    sum per texel or material row, and the same bits on two calls. Ids
    uniform over the 50k scene's two 64x64 textures (a third of the lanes
    masked), every lane on one texel, and the 50k tri pack's 49,970
    triangles onto its 3 materials."""
    from pbrpathtracer_tpu_torch.diff.params import MATERIAL_FIELDS
    from pbrpathtracer_tpu_torch.ops.shadepack import DIFFUSE, _tri_pack
    from pbrpathtracer_tpu_torch.ops.texture import (sample_texture,
                                                     texel_coords)
    scene = mesh_scene(50_000)
    rs = np.random.RandomState(len(case))
    f32 = dict(dtype=torch.float32, device=dev)
    if case.startswith("texture"):
        tex = scene.textures
        K, PH, PW, C = tex.data.shape
        n = 262_144
        idx = torch.tensor(rs.randint(-1, K, n), dtype=torch.int32,
                           device=dev)
        uv = torch.tensor(rs.uniform(-2, 2, (n, 2)), **f32)
        if case == "texture one texel":
            idx.fill_(1)
            uv[:] = torch.tensor([0.3, 0.6], **f32)
        mask = idx >= 0
        cot = torch.tensor(rs.randn(n, C), **f32)
        zeros = torch.zeros((n, C), **f32)

        def grad():
            data = tex.data.detach().clone().requires_grad_()
            out = sample_texture(dataclasses.replace(tex, data=data), idx, uv,
                                 zeros, mask)
            return torch.autograd.grad((out * cot).sum(), data)[0] \
                .reshape(-1, C)
        safe = torch.where(mask, idx, 0)
        x, y = texel_coords(tex, safe, uv)
        ref = _f64_sums(torch.where(mask, (safe * PH + y) * PW + x, -1), cot,
                        K * PH * PW)
        if case == "texture one texel":
            assert int(ref.any(dim=1).sum()) == 1
    else:
        m = scene.materials
        cot = torch.tensor(rs.randn(scene.geom.num_triangles, 55), **f32)

        def grad():
            leaves = {f: getattr(m, f).detach().clone().requires_grad_()
                      for f in MATERIAL_FIELDS}
            pack = _tri_pack(scene.geom, dataclasses.replace(m, **leaves))
            grads = torch.autograd.grad((pack * cot).sum(),
                                        list(leaves.values()))
            return torch.cat([g.reshape(len(g), -1) for g in grads], dim=1)
        # the float material leaves are the table's first 14 columns
        first = DIFFUSE.start
        ref = _f64_sums(scene.geom.mat_id, cot[:, first:first + 14],
                        m.num_materials)
    (a, b), ran = _ran(lambda: (grad(), grad()))
    assert ran["gather_rows_t_bwd"] == 2
    assert torch.equal(a, b)
    torch.testing.assert_close(a.double(), ref, rtol=1e-6, atol=1e-9)


def _index_backwards(kernels):
    """Launches of torch's indexing-backward kernels in a ``device_kernels``
    reading."""
    return sum(c for name, (c, _) in kernels.items()
               if "indexing_backward" in name)


def test_captured_textured_fwd_bwd_runs_no_index_backward(dev):
    """A replay of the captured fwd+bwd of a textured scene on K4 launches
    no torch indexing backward for its texture reads and material joins:
    none at all when the textures alone are differentiated; with the
    materials too, only the light pack's (it indexes its few rows with
    torch), as many as one light-pack backward launches, per light-pack
    build: one a sample, however many segments fetch from it."""
    from chip_smoke import device_kernels
    from pbrpathtracer_tpu_torch.ops import shadepack as sp
    from pbrpathtracer_tpu_torch.utils.roofline import record_launches
    scene, cam, cfg = _compiled_case("mesh3k", dev)
    cfg = cfg.replace(spp=1)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    counts = {}
    for what, sel in (("textures", dict(materials=False, textures=True)),
                      ("both", dict(materials=True, textures=True))):
        grad_render(scene, cam, cfg, target, **sel)
        grad_render(scene, cam, cfg, target, **sel)     # captured here
        counts[what] = _index_backwards(device_kernels(
            lambda: grad_render(scene, cam, cfg, target, **sel)))
    assert counts["textures"] == 0

    with record_launches() as records:
        _eager_grad(scene, cam, cfg, target, materials=True, textures=True)
    light_fetches = sum(1 for kernel, shapes in records
                        if kernel == "gather_rows_t_bwd"
                        and shapes["width"] == sp.LIGHT_PACK_WIDTH)
    del records

    def light_pack_backward():
        m = scene.materials
        em, ei = (x.detach().clone().requires_grad_()
                  for x in (m.emissive, m.emissive_intensity))
        pack = sp.build_light_pack(dataclasses.replace(
            scene, materials=dataclasses.replace(
                m, emissive=em, emissive_intensity=ei)))
        torch.autograd.grad(pack.sum(), (em, ei))
    per_build = _index_backwards(device_kernels(light_pack_backward))
    assert light_fetches > cfg.spp and per_build > 0
    assert counts["both"] == cfg.spp * per_build


def test_k3_launches_per_step_are_fetches_texture_reads_and_tri_builds(
        dev, monkeypatch):
    """``gather_rows_t_bwd``'s launches over one fwd+bwd of a textured scene,
    eager and replayed: one per pack fetch (tri pack W = 55, light pack
    W = 13), one per tri-pack build (its material join, W = 21: one a
    sample, the segments' cotangents of the pack summed first) and one per
    texture read whose value reaches the loss (W = 4; of the five reads a
    segment, a read that feeds only the rays after the last segment gets no
    gradient, so no backward)."""
    from collections import Counter
    from pbrpathtracer_tpu_torch.ops import shade
    from pbrpathtracer_tpu_torch.utils.roofline import record_launches
    scene, cam, cfg = _compiled_case("mesh3k", dev)
    cfg = cfg.replace(spp=1)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    sel = dict(materials=True, textures=True)
    reads, reached = [], []
    sample_texture = shade.sample_texture

    def watched(*args):
        out = sample_texture(*args)
        reads.append(out)
        out.register_hook(lambda g: reached.append(len(reached)))
        return out
    monkeypatch.setattr(shade, "sample_texture", watched)
    with record_launches() as records:
        _, ran = _ran(lambda: _eager_grad(scene, cam, cfg, target, **sel))
        eager = ran["gather_rows_t_bwd"]
    monkeypatch.undo()
    widths = Counter(shapes["width"] for kernel, shapes in records
                     if kernel == "gather_rows_t_bwd")
    del records, reads
    segments = widths[55]
    assert segments > 0 and 3 * segments <= len(reached) <= 5 * segments
    assert widths == {55: segments, 13: segments, 21: cfg.spp,
                      4: len(reached)}
    assert eager == sum(widths.values())
    grad_render(scene, cam, cfg, target, **sel)
    grad_render(scene, cam, cfg, target, **sel)       # captured here
    _, ran = _ran(lambda: grad_render(scene, cam, cfg, target, **sel))
    assert ran["gather_rows_t_bwd"] == eager


EDITS = """
import dataclasses
import torch
from pbrpathtracer_tpu_torch import Camera, RenderConfig, builders
from pbrpathtracer_tpu_torch.engine.session import RenderSession
from pbrpathtracer_tpu_torch.ops.integrator import render_sample
dev = torch.device("cuda", 0)
cam = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                  up=(0, 1, 0), fovy=61).to(dev)
cfg = RenderConfig(width=256, height=192, max_depth=3, seed=4)
scene = builders.cornell_box(device=dev)
for k in range(16):
    diffuse = scene.materials.diffuse.clone()
    diffuse[4] = torch.tensor((0.1 + 0.05 * k, 0.5, 0.9 - 0.05 * k), device=dev)
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, diffuse=diffuse))
    s = RenderSession(scene=scene, camera=cam, cfg=cfg, device=dev)
    s.start()
    s.step(3)
    print(torch.cuda.memory_reserved(dev))
with torch.inference_mode():
    eager = sum(render_sample(scene, cam, cfg, k) for k in range(3))
print(bool(torch.equal(eager, s.accum)))
"""


def test_a_session_restarted_on_edited_scenes_keeps_its_memory(dev):
    """A session restarted on a recoloured scene after every third pass
    (each edit a new key, captured at its second pass), in a process of its
    own so that no other test's keys or tensors count: the dropped keys'
    graph pools go back to the card, so the memory reserved stays where the
    third edit left it, and the passes equal eager ones."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", EDITS], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.split()
    reserved = [int(x) for x in lines[:-1]]
    assert len(reserved) == 16
    assert max(reserved[3:]) <= reserved[2] + (64 << 20), reserved
    assert lines[-1] == "True"


# ---- the fused forward shading segment (csrc/shade.cu) -----------------------

def _differ(a, b):
    """{field: lanes that differ} between two states, torch.equal's way."""
    out = {}
    for f in shade_cases.FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        if not torch.equal(x, y):
            ne = x != y
            if ne.dim() > 1:
                ne = ne.any(-1)
            lanes = ne.nonzero().flatten()
            out[f] = (int(lanes.numel()), lanes[:4].tolist())
    return out


@pytest.mark.parametrize("word", ["int", "tensor"])
@pytest.mark.parametrize("name", ["cornell", "textured", "translucent",
                                  "ggx_rr_nee", "no_lights"])
def test_fused_shading_equals_the_torch_chain(dev, name, word):
    """Every segment of a 256x192 sample, at three seeds: the fused
    kernels (``shade_segment`` on the card, no graph) against
    ``shade_plain`` from the same state and hits, every field of the state
    with ``torch.equal``; the seed and sample index as Python ints or as
    0-d device tensors (read through their pointers)."""
    from pbrpathtracer_tpu_torch.ops import shade
    scene, cam, cfg = shade_cases.case(name, dev, 256, 192, 50_000)
    for seed in (2 ** 31 + 11, 7, 123_456_789):
        seed_w, sample_w = seed, 5
        if word == "tensor":
            seed_w = torch.tensor(seed, dtype=torch.int64, device=dev)
            sample_w = torch.tensor(5, dtype=torch.int64, device=dev)
        fused = []

        def shade_fused(*args):
            out, moved = obs.counted(lambda: shade.shade_segment(*args))
            fused.append(moved.get("fused_shades", 0))
            return out
        segs = 0
        for seg, a, b in shade_cases.segment_pairs(
                scene, cam, cfg, seed_w, sample_w, shade_fused,
                shade.shade_plain):
            assert _differ(a, b) == {}, (name, seed, seg, _differ(a, b))
            segs += 1
        assert segs >= 2 and fused == [1] * segs


def test_captured_pass_with_fused_shading_equals_the_eager_pass(dev):
    """A session pass replayed from its graphs equals the eager pass bit
    for bit with the fused kernels in both, and counts one
    ``fused_shades`` per segment run, eager or replayed."""
    from pbrpathtracer_tpu_torch.engine.compiled import SAMPLES
    for name in ("cornell", "textured", "translucent"):
        scene, cam, cfg = shade_cases.case(name, dev, 256, 192, 50_000)
        for k in range(2):                 # eager, then the capture
            SAMPLES.sample(scene, cam, cfg, k)
        for k in (2, 3):
            (img, moved) = obs.counted(
                lambda: SAMPLES.sample(scene, cam, cfg, k))
            with torch.inference_mode():
                eager, em = obs.counted(
                    lambda: render_sample(scene, cam, cfg, k))
            assert torch.equal(img, eager), (name, k)
            assert moved["fused_shades"] == moved["segments"] > 0
            assert em["fused_shades"] == em["segments"] == moved["segments"]


@pytest.mark.parametrize("leaves", shade_cases.LEAVES)
def test_a_gradient_on_the_card_shades_by_the_torch_chain(dev, leaves):
    """A call on the card that records a graph shades by the torch chain
    and counts no ``fused_shades``, whichever leaves require grad: one
    segment of the textured mesh under grad has the loss and gradients of
    ``shade_plain`` called directly; with the materials, the textures or
    the camera's lens as ``get_params``' leaves, a fwd+bwd, eager or
    captured, has the eager fwd+bwd's gradients through ``shade_plain``,
    while its target render (no graph) takes the kernels. Deterministic
    algorithms, so that both sides may be held bit for bit."""
    from pbrpathtracer_tpu_torch.diff.loss import eager_loss_and_grad
    from pbrpathtracer_tpu_torch.diff.params import get_params
    from pbrpathtracer_tpu_torch.ops import shade

    def equal(a, b):
        (la, ga), (lb, gb) = a, b
        assert torch.equal(la, lb) and ga.keys() == gb.keys()
        for k, g in ga.items():
            assert (g is None) == (gb[k] is None), k
            assert g is None or torch.equal(g, gb[k]), (leaves, k)

    def plain(*args):
        return shade.shade_plain(*args)
    torch.use_deterministic_algorithms(True)
    try:
        scene, cam, cfg = shade_cases.case("textured", dev, 64, 48, 3000)
        got, moved = obs.counted(lambda: shade_cases.segment_grads(
            scene, cam, cfg, leaves, shade.shade_segment))
        assert moved.get("fused_shades", 0) == 0
        equal(got, shade_cases.segment_grads(scene, cam, cfg, leaves,
                                             shade.shade_plain))
        assert any(g is not None and bool(g.abs().sum() > 0)
                   for g in got[1].values())
        if leaves == "geometry":           # not a get_params leaf
            return
        cfg = cfg.replace(spp=1)
        target, moved = obs.counted(lambda: render(scene, cam, cfg))
        assert moved["fused_shades"] > 0
        params = get_params(scene, cam, materials=leaves == "materials",
                            textures=leaves == "textures",
                            camera_lens=leaves == "camera")
        eager, moved = obs.counted(lambda: eager_loss_and_grad(
            params, scene, cam, cfg, target * 0.9))
        assert moved.get("fused_shades", 0) == 0
        for _ in range(3):                 # eager, capture, replay
            _, moved = obs.counted(lambda: grad_render(
                scene, cam, cfg, target * 0.9,
                materials=leaves == "materials",
                textures=leaves == "textures",
                camera_lens=leaves == "camera"))
            assert moved.get("fused_shades", 0) == 0
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(shade, "_shade", plain)
            equal(eager, eager_loss_and_grad(params, scene, cam, cfg,
                                             target * 0.9))
    finally:
        torch.use_deterministic_algorithms(False)

"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

K1, K2 and K4 are built to agree with their plain versions bit for bit
(``--fmad=false``, IEEE division), so those comparisons are exact. K3 sums in
double in a fixed order: it is held to an f64 reference at rtol 1e-6, atol
1e-5 and must give the same bits on every call; its plain version
(``index_add_`` with float atomics on the card) agrees to f32 round-off.
"""

import numpy as np
import pytest
import torch

from chip_smoke import flat_plane_scene
from pbrpathtracer_tpu_torch import (Camera, RenderConfig, builders,
                                     grad_render, render)
from pbrpathtracer_tpu_torch.kernels import intersect as KI
from pbrpathtracer_tpu_torch.kernels import intersect_list as KL
from pbrpathtracer_tpu_torch.kernels import packgather as KP
from pbrpathtracer_tpu_torch.scene.big_scenes import (mesh_scene,
                                                      mesh_scene_camera)
from pbrpathtracer_tpu_torch.scene.scene import finalize_scene, pack_geometry

pytestmark = pytest.mark.gpu

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
    geom = getattr(builders, name)().to(dev).geom
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
    geom = getattr(builders, name)().to(dev).geom
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
    a = builders.cornell_box().to(dev).geom
    b = builders.cornell_spheres_scene().to(dev).geom
    rays = _rays(8, 4096, dev)
    first = KI.intersect_dense(a, *rays)
    prep = a._k1_prepared[1]
    _assert_same(KI.intersect_dense(b, *rays),
                 KI.intersect_dense_plain(b, *rays))
    before = KI.intersect_dense.launches
    _assert_same(KI.intersect_dense(a, *rays), first)
    assert KI.intersect_dense.launches == before + 1
    assert a._k1_prepared[1] is prep and b._k1_prepared[1] is not prep


@pytest.mark.parametrize("T,W,N", [(36, 55, 262_144), (2, 13, 1000),
                                   (588, 55, 100_000), (1000, 55, 77),
                                   (256, 7, 0), (49_970, 55, 262_144),
                                   (1_000_000, 55, 65_536)])
def test_packgather_kernel_matches_plain(dev, T, W, N):
    """Tables that fit the 48 KB staging limit and tables that do not, up
    to the tri packs of the 50k and 1M mesh scenes."""
    rs = np.random.RandomState(T)
    table = torch.tensor(rs.randn(T, W), dtype=torch.float32, device=dev)
    idx = rs.randint(-2, T + 2, N)
    idx = torch.tensor(idx, dtype=torch.int32, device=dev)
    out = KP.gather_rows_t(table, idx)
    assert torch.equal(out, KP.gather_rows_t_plain(table, idx))


def test_packgather_rejects_mixed_devices(dev):
    table = torch.zeros((4, 3), device=dev)
    with pytest.raises(ValueError):
        KP.gather_rows_t(table, torch.zeros(5, dtype=torch.int32))


def test_render_goes_through_the_kernels_only(dev):
    cfg = RenderConfig(width=32, height=32, max_depth=3, spp=2, seed=1)
    scene = builders.cornell_box()
    counters = (KI.intersect_dense, KI.intersect_dense_plain,
                KP.gather_rows_t, KP.gather_rows_t_plain)
    for fn in counters:
        fn.launches = 0
    img = render(scene.to(dev), Camera.make(**POSE), cfg)
    torch.cuda.synchronize()
    assert KI.intersect_dense.launches > 0 and KP.gather_rows_t.launches > 0
    assert KI.intersect_dense_plain.launches == 0
    assert KP.gather_rows_t_plain.launches == 0
    # the same render on the CPU: identical up to knife-edge pixels, where an
    # ULP of difference between the CPU's and the card's sin/cos/sqrt can
    # flip a decision
    ref = render(scene, Camera.make(**POSE), cfg)
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
    before = KP.gather_rows_t_bwd.launches
    KP.gather_rows_t(table, idx).sum().backward()
    torch.cuda.synchronize()
    assert KP.gather_rows_t_bwd.launches == before + 1
    counts = torch.bincount(idx.long(), minlength=36).float()
    torch.testing.assert_close(table.grad, counts[:, None].expand(36, 55),
                               rtol=0, atol=0)


def test_grad_render_goes_through_the_kernels_only(dev):
    cfg = RenderConfig(width=32, height=32, max_depth=3, spp=1, seed=1)
    scene = builders.cornell_box().to(dev)
    cam = Camera.make(**POSE)
    counters = (KI.intersect_dense, KI.intersect_dense_plain,
                KP.gather_rows_t, KP.gather_rows_t_plain,
                KP.gather_rows_t_bwd, KP.gather_rows_t_bwd_plain)
    for fn in counters:
        fn.launches = 0
    loss, grads = grad_render(scene, cam, cfg,
                              torch.zeros((32, 32, 3), device=dev))
    torch.cuda.synchronize()
    assert KI.intersect_dense.launches > 0 and KP.gather_rows_t.launches > 0
    assert KP.gather_rows_t_bwd.launches > 0
    assert KI.intersect_dense_plain.launches == 0
    assert KP.gather_rows_t_plain.launches == 0
    assert KP.gather_rows_t_bwd_plain.launches == 0
    assert all(torch.isfinite(g).all() for g in grads.values())
    # the same gradients on the CPU, up to f32 round-off (knife-edge lanes
    # aside, none of which this image has measured)
    ref_loss, ref = grad_render(builders.cornell_box(), cam, cfg,
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
    scene = mesh_scene(3000, accel=accel).to(dev)
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
    scene = mesh_scene(3000, accel="none").to(dev)
    ro, rd, t_lower, alive = _scene_rays(0, 256, dev)
    KL.intersect_list(scene.geom, ro, rd, t_lower, alive)
    prep = scene.geom._k4_prepared[1]
    KL.intersect_list(scene.geom, ro, rd, t_lower, alive)
    assert scene.geom._k4_prepared[1] is prep
    assert scene.accel is None and torch.equal(prep.pos, prep.perm)


def test_cuda_queries_never_reach_the_list_plain_version(dev, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CUDA query took the plain version")
    scene = mesh_scene(3000, accel="always").to(dev)
    ro, rd, t_lower, alive = _scene_rays(1, 512, dev)
    monkeypatch.setattr(KL, "intersect_list_plain", refuse)
    before = KL.intersect_list.launches
    KL.intersect_list(scene.geom, ro, rd, t_lower, alive, accel=scene.accel)
    assert KL.intersect_list.launches == before + 1


def test_large_scene_render_goes_through_k4_only(dev):
    cfg = RenderConfig(width=32, height=32, max_depth=3, spp=1, seed=1)
    scene = mesh_scene(6000)
    counters = (KI.intersect_dense, KI.intersect_dense_plain,
                KL.intersect_list, KL.intersect_list_plain,
                KP.gather_rows_t, KP.gather_rows_t_plain)
    for fn in counters:
        fn.launches = 0
    img = render(scene.to(dev), mesh_scene_camera(), cfg)
    torch.cuda.synchronize()
    assert KL.intersect_list.launches > 0 and KP.gather_rows_t.launches > 0
    assert KI.intersect_dense.launches == 0
    assert KI.intersect_dense_plain.launches == 0
    assert KL.intersect_list_plain.launches == 0
    assert KP.gather_rows_t_plain.launches == 0
    ref = render(scene, mesh_scene_camera(), cfg)
    d = (img.cpu() - ref).abs().amax(dim=-1)
    assert (d > 1e-3).float().mean() <= 0.005
    assert d[d <= 1e-3].mean() < 1e-4


@pytest.mark.parametrize("mode,order", [("sort", "scan"), ("gather", "scan"),
                                        ("off", "block"), ("sort", "block")])
def test_reordered_renders_are_bit_identical_on_the_card(dev, mode, order):
    scene = mesh_scene(6000).to(dev)
    kw = dict(width=64, height=48, max_depth=3, spp=1, seed=2)
    ref = render(scene, mesh_scene_camera(), RenderConfig(
        compact_wavefront="off", pixel_order="scan", **kw))
    img = render(scene, mesh_scene_camera(), RenderConfig(
        compact_wavefront=mode, pixel_order=order, **kw))
    assert torch.equal(img, ref)

"""The port's measurement layer on the CPU: ``bench``'s counting, its
roofline (``utils/roofline.py``) and the bench's refusal without a card.

* ``bench.count_rays`` on Cornell 16x16 depth 4: the live lanes per segment
  and the rays per sample equal the JAX package's ``wavefront_occupancy``
  (integer counts: exact).
* ``bench.reference_baseline()`` equals the JAX one (exact).
* The dispatch counter: ``a + b`` over f32[1000] moves 12,000 bytes and does
  1,000 operations; a view moves nothing; a broadcast input counts its
  distinct elements; a reduction, a matrix product (hand-counted, exact).
* The per-kernel reckonings equal the formulas ``chip_smoke.py`` held each
  kernel's time against before they moved here (exact, integers).
* ``build`` equals the JAX ``build`` given the same peaks (rel 1e-12).
* The canonical counted steps on the CPU (the kernels' plain versions run,
  so no launch is recorded and their operators are counted instead).
"""

import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu import bench as j_bench
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu.utils import roofline as j_roofline
from pbrpathtracer_tpu.utils.observability import (
    wavefront_occupancy as j_occupancy)
from pbrpathtracer_tpu_torch import bench
from pbrpathtracer_tpu_torch.utils import roofline

# chip_smoke.py's reckonings before they moved to utils/roofline.py
PAIR_OPS, SLAB_OPS = 47, 27


def former_k1(n, T):
    return n * (24 + 4 + 1 + 17) + T * 36 + 24, n * (SLAB_OPS + T * PAIR_OPS)


def former_k2_bytes(n, W, rows):
    return 4 * n + 4 * W * rows + 4 * W * n


def former_k3(n, T, W):
    return n * 4 + n * W * 4 + T * W * 4, n * W


def former_k4(n_rays, nodes, tris, hits, leaf):
    levels = max(1, (nodes + 1).bit_length() - 1)
    return (n_rays * (24 + 4 + 1 + 17) + nodes * 48 + tris * 44,
            n_rays * levels * SLAB_OPS + hits * leaf * PAIR_OPS)


def former_k4_walk(n_rays, nodes_per_ray, tris_per_ray):
    return (n_rays * (24 + 4 + 1 + 17 + nodes_per_ray * 128
                      + tris_per_ray * 48),
            n_rays * (nodes_per_ray * 4 * SLAB_OPS + tris_per_ray * PAIR_OPS))


def former_bound_ms(n_bytes, n_ops):
    by_bytes, by_ops = n_bytes / 3.35e12 * 1e3, n_ops / 67e12 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def test_count_rays_matches_jax_occupancy():
    scene, camera, cfg = bench.flagship("cpu", 16, 16)
    live, rays, live_segments = bench.count_rays(scene, camera, cfg)
    jlive = np.asarray(j_occupancy(
        jb.cornell_box(), JCamera.make(**bench.CAMERA_POSE),
        JConfig(width=16, height=16, max_depth=bench.DEPTH, spp=bench.SPP,
                seed=0)))
    np.testing.assert_array_equal(live, jlive)
    assert rays == 2 * int(jlive.sum())
    assert live_segments == int((jlive > 0).sum()) < len(jlive)


def test_reference_baseline_matches_jax():
    assert bench.reference_baseline() == j_bench.reference_baseline()
    ref, info = bench.reference_baseline()
    assert ref > 0 and info["vs_baseline_is_estimate"] is False


def test_bench_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    with pytest.raises((AssertionError, RuntimeError),
                       match="(?i)cuda|nvidia"):
        bench.measure_flagship()


A = torch.arange(1000, dtype=torch.float32)
B = torch.ones(1000)
M = torch.ones((8, 5))
N = torch.ones((5, 3))


@pytest.mark.parametrize("fn,want", [
    (lambda: A + B, (12_000, 1_000)),
    (lambda: A.view(10, 100), (0, 0)),
    (lambda: A[None, :].expand(5, 1000) + B, (4_000 + 4_000 + 20_000,
                                              5_000)),
    (lambda: A.sum(), (4_004, 1_000)),
    (lambda: (A > 3), (4_000 + 1_000, 0)),
    (lambda: M @ N, (160 + 60 + 96, 2 * 8 * 5 * 3)),
    (lambda: torch.empty(1000), (0, 0)),
], ids=["add", "view", "broadcast", "sum", "compare", "matmul", "empty"])
def test_program_counter(fn, want):
    _, cost = roofline.count_program(fn)
    assert (cost.program_bytes, cost.program_ops) == want
    assert cost.kernel_bytes == cost.kernel_ops == 0 and cost.launches == {}


@pytest.mark.parametrize("n,T", [(262_144, 36), (1000, 588), (1, 1)])
def test_k1_reckoning(n, T):
    assert roofline.k1_work(n, T) == former_k1(n, T)
    assert roofline.bound_ms(*roofline.k1_work(n, T)) == \
        former_bound_ms(*former_k1(n, T))


@pytest.mark.parametrize("n,T,W", [(262_144, 36, 55), (262_144, 49_970, 55),
                                   (4096, 2, 13), (31, 999_956, 7)])
def test_k2_k3_reckonings(n, T, W):
    rs = np.random.RandomState(0)
    idx = torch.tensor(rs.randint(-3, T + 3, size=n), dtype=torch.int32)
    rows = roofline.rows_named(idx, T)
    ids = idx.numpy()
    assert rows == len(set(ids[(ids >= 0) & (ids < T)].tolist()))
    assert roofline.k2_work(n, W, rows) == (former_k2_bytes(n, W, rows), 0)
    assert roofline.k3_work(n, T, W) == former_k3(n, T, W)
    assert roofline.bound_ms(*roofline.k3_work(n, T, W)) == \
        former_bound_ms(*former_k3(n, T, W))


@pytest.mark.parametrize("n,nodes,tris,hits,leaf", [
    (262_144, 16_109, 49_970, 200_000, 8), (16_384, 338_243, 999_956, 9, 8),
    (1, 1, 3, 0, 4)])
def test_k4_reckonings(n, nodes, tris, hits, leaf):
    assert roofline.k4_work(n, nodes, tris, hits, leaf) == \
        former_k4(n, nodes, tris, hits, leaf)
    assert roofline.k4_walk_work(n, 8.3, 11.25) == \
        former_k4_walk(n, 8.3, 11.25)


def test_launch_records_priced_by_the_reckonings():
    """kernel_work over records as the wrappers write them."""
    alive = torch.tensor([True, False, True, True])
    idx = torch.tensor([0, 0, 5, -1], dtype=torch.int32)
    hit = torch.tensor([True, False, False, True])
    records = [
        ("intersect_dense", {"n": 4, "alive": alive, "n_tris": 36}),
        ("intersect_dense", {"n": 4, "alive": None, "n_tris": 36}),
        ("gather_rows_t", {"idx": idx, "n_rows": 6, "width": 55}),
        ("gather_rows_t_bwd", {"n": 4, "n_rows": 6, "width": 55}),
        ("intersect_list", {"n": 4, "alive": alive, "hit": hit,
                            "n_nodes": 15, "n_tris": 60, "leaf_size": 8}),
    ]
    parts = [roofline.k1_work(3, 36), roofline.k1_work(4, 36),
             roofline.k2_work(4, 55, 2), roofline.k3_work(4, 6, 55),
             roofline.k4_work(3, 15, 60, 2, 8)]
    got = roofline.kernel_work(records)
    assert got["bytes"] == sum(b for b, _ in parts)
    assert got["ops"] == sum(o for _, o in parts)
    assert got["launches"] == {"intersect_dense": 2, "gather_rows_t": 1,
                               "gather_rows_t_bwd": 1, "intersect_list": 1}
    with pytest.raises(ValueError, match="no reckoning"):
        roofline.launch_work("intersect_list_stats", {})


def test_record_launches_is_one_window():
    from pbrpathtracer_tpu_torch.kernels import native
    with roofline.record_launches() as records:
        assert native.launch_records is records == []
        with pytest.raises(RuntimeError, match="already open"):
            with roofline.record_launches():
                pass
    assert native.launch_records is None


@pytest.mark.parametrize("n_bytes,flops,kernel_flops", [
    (1e9, 1e9, 0.0), (1e6, 1e10, 2e9), (0.0, 0.0, 0.0), (3.2e8, 4e9, 6e9)])
def test_build_matches_jax(n_bytes, flops, kernel_flops):
    j = j_roofline.build(n_bytes, flops, kernel_flops)
    p = roofline.build(n_bytes, flops, kernel_flops,
                       hbm_bytes_per_s=j_roofline.HBM_BYTES_PER_S,
                       fp32_flops_per_s=j_roofline.VPU_F32_FLOPS)
    assert p.t_hbm_s == pytest.approx(j.t_hbm_s, rel=1e-12)
    assert p.t_fp32_s == pytest.approx(j.t_vpu_s, rel=1e-12)
    assert p.t_roofline_s == pytest.approx(j.t_roofline_s, rel=1e-12)
    assert p.bound == {"hbm": "hbm", "vpu": "fp32"}[j.bound]
    for t in (1e-3, 0.0):
        assert p.fraction(t) == pytest.approx(j.fraction(t), rel=1e-12)
        assert p.as_dict(t)["fraction_of_roofline"] == \
            j.as_dict(t)["fraction_of_roofline"]


def test_canonical_counted_steps_on_the_cpu():
    scene, camera, cfg = bench.flagship("cpu", 8, 8)
    live, _, live_segments = bench.count_rays(scene, camera, cfg)
    fwd, fwdbwd = bench.roofline_costs(scene, camera, cfg, live_segments)
    assert 0 < fwd.program_bytes < fwdbwd.program_bytes
    assert 0 < fwd.operator_calls < fwdbwd.operator_calls
    assert fwd.launches == fwdbwd.launches == {}   # plain versions on the CPU
    # one segment fewer counts less: the schedule is the live segments only
    fewer, _ = bench.roofline_costs(scene, camera, cfg, live_segments - 1)
    assert fewer.program_bytes < fwd.program_bytes
    rl = fwd.roofline()
    assert rl.bound in ("hbm", "fp32") and rl.t_roofline_s > 0

"""The frozen yardstick (``harness/yardstick.py``) equals the program's
reckonings (``utils/roofline.py``) on the same shapes today; a later change
to the program's copy does not move the benchmark's."""

import pytest

from perfbench.harness import yardstick as ys
from pbrpathtracer_tpu_torch.utils import roofline


@pytest.mark.parametrize("rays, tris", [(0, 36), (262_144, 36),
                                        (786_432, 2048)])
def test_k1(rays, tris):
    assert ys.k1_work(rays, tris) == roofline.k1_work(rays, tris)


@pytest.mark.parametrize("n, width, rows", [(262_144, 55, 22),
                                            (786_432, 13, 2),
                                            (262_144, 55, 11_940)])
def test_k2(n, width, rows):
    assert ys.k2_work(n, width, rows) == roofline.k2_work(n, width, rows)


@pytest.mark.parametrize("n, rows, width", [(262_144, 36, 55),
                                            (262_144, 49_970, 13)])
def test_k3(n, rows, width):
    assert ys.k3_work(n, rows, width) == roofline.k3_work(n, rows, width)


@pytest.mark.parametrize("rays, tris, hits", [(262_144, 49_970, 200_000),
                                              (5, 999_956, 0)])
def test_k4(rays, tris, hits):
    nodes = ys.binary_bvh_nodes(tris)
    assert ys.k4_work(rays, nodes, tris, hits, ys.LEAF_SIZE) == \
        roofline.k4_work(rays, nodes, tris, hits, ys.LEAF_SIZE)


@pytest.mark.parametrize("n_bytes, ops", [(1e9, 1e3), (10, 1e12)])
def test_bound_and_peaks(n_bytes, ops):
    assert ys.HBM_BYTES_PER_S == roofline.HBM_BYTES_PER_S
    assert ys.FP32_FLOPS_PER_S == roofline.FP32_FLOPS_PER_S
    assert ys.bound_ms(n_bytes, ops) == pytest.approx(
        roofline.bound_ms(n_bytes, ops)[0], rel=1e-12)


def test_binary_bvh_nodes_counts_the_median_split_tree():
    from pbrpathtracer_tpu_torch.accel.build import build_bvh
    import numpy as np
    rs = np.random.RandomState(0)
    for n in (1, 8, 9, 100, 1001):
        v0 = rs.rand(n, 3).astype(np.float32)
        bvh = build_bvh(v0, v0 + 0.01, v0 + 0.02, leaf_size=ys.LEAF_SIZE)
        assert bvh.num_nodes == ys.binary_bvh_nodes(n)


def test_kernel_names():
    assert ys.kernel_of("void intersect_dense_kernel<8>(float const*)") == "k1"
    assert ys.kernel_of("(anonymous namespace)::bwd_reduce_kernel(int)") == \
        "k3"
    assert ys.kernel_of("fwd_in_place_kernel") == "k2"
    assert ys.kernel_of("bvh_intersect_kernel") == "k4"
    assert ys.kernel_of("void at::native::vectorized_elementwise_kernel") \
        is None

"""The benchmark's frozen yardstick: the H100's published peaks and the
work of each hand-written kernel, reckoned from shapes.

Copied from the program's ``utils/roofline.py`` (``k1_work`` .. ``k4_work``,
``bound_ms`` and their constants) so that no later change to the program
moves the yardstick. The work is counted from what the benchmark's own
reference did (its live rays, hits and the rows its ids name), never from
the program's launch records.

Peaks of one NVIDIA H100 SXM5 80 GB at its 700 W limit (NVIDIA's data
sheet, dense rates): HBM3 3.35 TB/s, FP32 67 TFLOP/s outside the tensor
cores (the path issues no matrix product). A card set below 700 W runs
slower under load; the share is stated against the published peak.
"""

from __future__ import annotations

import functools

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# FP32 operations of one Möller-Trumbore pair test and of one slab test.
PAIR_OPS, SLAB_OPS = 47, 27
# Bytes of one ray's inputs and outputs to a closest-hit query: origin and
# direction (24), t_lower (4), alive (1); hit, id, t, u, v (17).
RAY_IO_BYTES = 24 + 4 + 1 + 17
# The leaf size of the binary BVH that prices K4's least walk.
LEAF_SIZE = 8

# The kernels by the names the device trace gives them.
KERNELS = {
    "k1": ("intersect_dense_kernel",),
    "k2": ("fwd_staged_kernel", "fwd_in_place_kernel"),
    "k3": ("bwd_zero_kernel", "bwd_sort_hist_kernel", "bwd_sort_scan_kernel",
           "bwd_sort_scatter_kernel", "bwd_reduce_kernel", "bwd_fixup_kernel"),
    "k4": ("bvh_intersect_kernel",),
}


def kernel_of(name: str) -> str | None:
    """"k1" .. "k4" for a device operation of that kernel, else None."""
    for k, names in KERNELS.items():
        if any(n in name for n in names):
            return k
    return None


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The least time for one kernel launch's work: its bytes at the HBM
    peak against its operations at the FP32 peak, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS_PER_S) * 1e3


def k1_work(n_rays: int, n_tris: int) -> tuple[int, int]:
    """K1, the dense closest hit, on ``n_rays`` live rays: each ray's inputs
    and outputs, the triangle rows (36 bytes) and one chunk box; one slab
    test and a pair test per triangle for each ray."""
    return (n_rays * RAY_IO_BYTES + n_tris * 36 + 24,
            n_rays * (SLAB_OPS + n_tris * PAIR_OPS))


def k2_work(n: int, width: int, rows: int) -> tuple[int, int]:
    """K2, the pack-gather forward, of ``n`` ids naming ``rows`` distinct
    rows of ``width`` floats: the ids read, each named row read once, the
    [W, N] output written. No arithmetic."""
    return 4 * n + 4 * width * rows + 4 * width * n, 0


def k3_work(n: int, n_rows: int, width: int) -> tuple[int, int]:
    """K3, the pack-gather backward: ids and the [W, N] cotangent read, the
    [T, W] table written; one addition per cotangent element."""
    return 4 * n + 4 * n * width + 4 * n_rows * width, n * width


def k4_work(n_rays: int, n_nodes: int, n_tris: int, hits: int,
            leaf_size: int) -> tuple[int, int]:
    """K4, the BVH closest hit, at its least walk: each ray's inputs and
    outputs, every node of the binary BVH (48 bytes) and triangle (44 bytes)
    once; one slab test per level of the binary tree for each live ray and
    one leaf of pair tests for each hit."""
    levels = max(1, (n_nodes + 1).bit_length() - 1)
    return (n_rays * RAY_IO_BYTES + n_nodes * 48 + n_tris * 44,
            n_rays * levels * SLAB_OPS + hits * leaf_size * PAIR_OPS)


@functools.lru_cache(maxsize=None)
def binary_bvh_nodes(n_tris: int, leaf_size: int = LEAF_SIZE) -> int:
    """Nodes of a binary BVH over ``n_tris`` triangles split in halves down
    to leaves of at most ``leaf_size``: counted from the triangle count
    alone, whatever tree the program walks."""
    if n_tris <= leaf_size:
        return 1
    half = n_tris // 2
    return 1 + binary_bvh_nodes(half, leaf_size) + binary_bvh_nodes(
        n_tris - half, leaf_size)

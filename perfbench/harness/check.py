"""What the loops' comparisons with the plain reference
(``perfbench/reference``) share: the reference's scene and configuration
of a run, and the worst leaf's gap between two sets of norms. Each loop
of ``perfbench/loops/`` holds its own numbers (``evaluate``), each against
its limit in ``perfbench/limits/<workload>.json``.
"""

from __future__ import annotations

import torch

from ..reference import pathtracer as ref

LEAF_FLOOR = 1e-3


def reference_scene(ctx):
    return (ref.build_scene(ctx.arrays, ctx.device),
            ref.make_camera(ctx.config["camera"], ctx.device))


def ref_config(ctx, prec="fp32"):
    """The reference's configuration of the run's render keys."""
    return ref.Config.of(ctx.render, ctx.seed, prec)


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else 0.0


def leaves_with_gradient(g_ref: dict) -> list:
    """The leaves whose reference gradient norm is at least ``LEAF_FLOOR``
    of the median over the leaves with a gradient."""
    median = _median(v for v in g_ref.values() if v > 0)
    return [k for k in g_ref if g_ref[k] >= LEAF_FLOOR * median
            and g_ref[k] > 0]


def worst_leaf_gap(got: dict, want: dict, kept: list) -> float:
    """The widest gap between the two norms of a kept leaf, over the larger
    of the reference's norm and the median kept leaf's."""
    median = _median(want[k] for k in kept)
    return max((abs(got[k] - want[k]) / max(want[k], median, 1e-30)
                for k in kept), default=float("inf"))

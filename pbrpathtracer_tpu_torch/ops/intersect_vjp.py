"""Custom backward for closest-hit queries, as
``pbrpathtracer_tpu.ops.intersect_vjp`` (``hit_vjp="winner"``).

Differentiating an intersector by autograd keeps every ray x triangle pair
for the backward, and the CUDA kernels have no reverse rule at all. But the
closest hit is locally a function of the winning triangle alone: with the hit
id fixed (the discrete argmin detaches, as every decision of the estimator
does), t, u and v are closed-form Möller-Trumbore ratios of (ro, rd) against
that one triangle. So:

  forward  = any intersector (the dense or the BVH kernel on the card, their
             plain versions on the CPU), recording no graph;
  backward = fetch the winner's (v0, e1, e2) rows and apply the closed-form
             pullback: O(N) instead of O(N T).

Cotangents flow to (ro, rd) only. The scene's geometry is a static leaf and
``t_lower`` only shifts the discrete selection, so both get none; ``alive``
is a mask. The rows come through ``gather_fields`` on the f32[T, 9] table
(v0, e1, e2): on the card the pack-gather kernel, launched from a backward.
"""

from __future__ import annotations

import torch

from ..utils.constants import EPS
from .linalg import cross, dot
from .shadepack import gather_fields

EPS = float(EPS)
TRI9_FIELDS = (slice(0, 3), slice(3, 6), slice(6, 9))


def winner_pullback(geom, ro, rd, hit, idx, ct, cu, cv):
    """(d_ro, d_rd) for the cotangents (ct, cu, cv) of a query's (t, u, v),
    whose winners are ``idx`` where ``hit``. Zero on misses and where the
    winner's determinant is below EPS."""
    tri9 = torch.cat([geom.v0, geom.e1, geom.e2], dim=1)
    v0, e1, e2 = gather_fields(tri9, idx, TRI9_FIELDS)
    h = cross(rd, e2)
    a = dot(e1, h)
    ok = torch.abs(a) >= EPS
    f = torch.where(ok, 1.0 / torch.where(ok, a, 1.0), 0.0)
    s = ro - v0
    q = cross(s, e1)
    sh = dot(s, h)
    rq = dot(rd, q)
    eq = dot(e2, q)

    z = hit.to(torch.float32)
    ct, cu, cv = ct * z, cu * z, cv * z

    e1xe2 = cross(e1, e2)
    e2xs = cross(e2, s)
    e1xrd = cross(e1, rd)
    fc = f[:, None]
    d_ro = (ct[:, None] * fc * e1xe2
            + cu[:, None] * fc * h
            + cv[:, None] * fc * e1xrd)
    # d rd: the shared -f^2 (e2 x e1) (sum of cotangent x numerator) term,
    # then the direct terms
    num = ct * eq + cu * sh + cv * rq
    d_rd = ((-f * f * num)[:, None] * (-e1xe2)
            + cu[:, None] * fc * e2xs
            + cv[:, None] * fc * q)
    return d_ro, d_rd


class _WinnerQuery(torch.autograd.Function):
    """Forward: ``intersect_fn`` as it is (an autograd Function's forward
    records no graph). Backward: ``winner_pullback``."""

    @staticmethod
    def forward(ctx, intersect_fn, scene, ro, rd, t_lower, alive):
        hit, idx, t, u, v = intersect_fn(scene, ro, rd, t_lower, alive=alive)
        ctx.mark_non_differentiable(hit, idx)
        ctx.save_for_backward(ro, rd, hit, idx)
        ctx.geom = scene.geom
        return hit, idx, t, u, v

    @staticmethod
    def backward(ctx, _c_hit, _c_idx, ct, cu, cv):
        ro, rd, hit, idx = ctx.saved_tensors
        d_ro, d_rd = winner_pullback(ctx.geom, ro, rd, hit, idx, ct, cu, cv)
        return None, None, d_ro, d_rd, None, None


def with_custom_vjp(intersect_fn):
    """Wrap ``intersect_fn(scene, ro, rd, t_lower, alive=None)`` with the
    winner-only backward. The returned callable has the same signature and
    returns the same values."""

    def wrapped(scene, ro, rd, t_lower, alive=None):
        return _WinnerQuery.apply(intersect_fn, scene, ro, rd, t_lower, alive)

    return wrapped

"""Ray-triangle closest hit in plain torch: the counterpart of
``pbrpathtracer_tpu.ops.intersect.intersect_classic`` and ``mask_dead``.

This is the route for CPU tensors and the plain version that the CUDA
closest-hit kernels (``kernels/intersect.py``, ``kernels/intersect_list.py``)
are held against. Möller–Trumbore runs in the kernels' operation order, one
elementwise op at a time, so on the card they agree bit for bit when the
kernels are built without FMA contraction.

Acceptance: |a| >= EPS, 0 <= u <= 1, v >= 0, u + v <= 1, t > EPS and
t > t_lower (an exclusive lower bound, used to re-trace past stochastically
transparent hits). Ties go to the lowest triangle id (``argmin``'s first
index).
"""

from __future__ import annotations

import torch

from ..scene.scene import Geometry
from ..utils.constants import EPS

EPS = float(EPS)
BIG = 3.0e38
# Ray x triangle pairs per block: bounds the [rays, T] temporaries.
PAIR_BUDGET = 1 << 22


def mask_dead(alive, hit, idx, t, u, v):
    """Dead lanes (``alive == False``) report a clean miss: hit False and
    idx/t/u/v zero. Live lanes are untouched."""
    if alive is None:
        return hit, idx, t, u, v
    return (hit & alive, torch.where(alive, idx, 0), torch.where(alive, t, 0.0),
            torch.where(alive, u, 0.0), torch.where(alive, v, 0.0))


def moller_trumbore(rox, roy, roz, rdx, rdy, rdz, v0x, v0y, v0z, e1x, e1y,
                    e1z, e2x, e2y, e2z):
    """The determinant and the three numerators (a, u_num, v_num, t_num) of
    ray-triangle pairs, by components that broadcast against each other, in
    the kernels' operation order."""
    hx = rdy * e2z - rdz * e2y
    hy = rdz * e2x - rdx * e2z
    hz = rdx * e2y - rdy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    sx = rox - v0x
    sy = roy - v0y
    sz = roz - v0z
    u_num = sx * hx + sy * hy + sz * hz
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v_num = rdx * qx + rdy * qy + rdz * qz
    t_num = e2x * qx + e2y * qy + e2z * qz
    return a, u_num, v_num, t_num


def hit_tests(a, u_num, v_num, t_num, t_lower):
    """Acceptance tests on [rays, triangles] pairs; returns (t with misses
    at BIG, u, v)."""
    denom_ok = torch.abs(a) >= EPS
    f = torch.where(denom_ok, 1.0 / torch.where(denom_ok, a, 1.0), 0.0)
    u = u_num * f
    v = v_num * f
    t = t_num * f
    valid = (denom_ok
             & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & (t > EPS) & (t > t_lower[:, None]))
    return torch.where(valid, t, BIG), u, v


def intersect_classic(geom: Geometry, ro, rd, t_lower=None, alive=None):
    """Closest hit of each ray against every triangle.

    Returns (hit bool[N], tri_idx i32[N], t f32[N], u f32[N], v f32[N]); a
    miss has idx, t, u and v zero. ``alive`` masks lanes to a clean miss.
    """
    N = ro.shape[0]
    T = geom.num_triangles
    if t_lower is None:
        t_lower = torch.zeros(N, dtype=torch.float32, device=ro.device)
    # triangle components as [1, T] rows
    v0x, v0y, v0z = (geom.v0[:, k][None] for k in range(3))
    e1x, e1y, e1z = (geom.e1[:, k][None] for k in range(3))
    e2x, e2y, e2z = (geom.e2[:, k][None] for k in range(3))

    best_t = torch.full((N,), BIG, dtype=torch.float32, device=ro.device)
    best_i = torch.zeros(N, dtype=torch.int32, device=ro.device)
    best_u = torch.zeros(N, dtype=torch.float32, device=ro.device)
    best_v = torch.zeros(N, dtype=torch.float32, device=ro.device)
    rows = max(1, PAIR_BUDGET // max(T, 1))
    for r0 in range(0, N, rows):
        sl = slice(r0, r0 + rows)
        rdx, rdy, rdz = (rd[sl, k:k + 1] for k in range(3))   # [n, 1]
        rox, roy, roz = (ro[sl, k:k + 1] for k in range(3))
        a, u_num, v_num, t_num = moller_trumbore(
            rox, roy, roz, rdx, rdy, rdz, v0x, v0y, v0z, e1x, e1y, e1z,
            e2x, e2y, e2z)
        t_m, u, v = hit_tests(a, u_num, v_num, t_num, t_lower[sl])
        arg = torch.argmin(t_m, dim=1, keepdim=True)
        best_t[sl] = t_m.gather(1, arg)[:, 0]
        best_u[sl] = u.gather(1, arg)[:, 0]
        best_v[sl] = v.gather(1, arg)[:, 0]
        best_i[sl] = arg[:, 0].to(torch.int32)
    hit = best_t < BIG
    zero = torch.zeros((), dtype=torch.float32, device=ro.device)
    return mask_dead(alive, hit, torch.where(hit, best_i, 0),
                     torch.where(hit, best_t, zero),
                     torch.where(hit, best_u, zero),
                     torch.where(hit, best_v, zero))

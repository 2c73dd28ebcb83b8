"""Brute-force closest hit for the reference, in plain torch.

Every ray is tested against every triangle whose chunk box it crosses:
the triangles are cut into chunks of ``CHUNK`` along a Morton order of
their centroids (the reference's own order, worked out here from the
vertices), each chunk gets a box, and a ray tests the triangles of each
chunk whose box its slab test passes. The boxes are widened by ``PAD``, so
the culling drops no triangle that the ray hits.

The pair test is Möller–Trumbore with the acceptance rules of the renderer:
|a| >= EPS, 0 <= u <= 1, v >= 0, u + v <= 1, t > EPS and t > t_lower (the
exclusive lower bound of the opacity re-trace). The closest t wins, and of
equal t the lowest triangle id in the scene's own order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EPS = float(np.float32(1e-5))
BIG = 3.0e38
CHUNK = 64
PAD = 1e-3
RAY_BLOCK = 1 << 16      # rays whose chunk boxes are tested at once
PAIR_BLOCK = 1 << 18     # (ray, chunk) pairs tested at once


def _morton(c):
    """30-bit Morton codes of points normalised into [0, 1]^3."""
    q = np.clip((c * 1023.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249
    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


@dataclasses.dataclass
class ChunkedTriangles:
    """Triangles in chunks: per slot the components of (v0, e1, e2) and the
    scene id (-1 and a degenerate triangle in the padding), per chunk its
    box."""
    comps: tuple          # 9 x f32[C, CHUNK]
    ids: torch.Tensor     # i64[C, CHUNK]
    lo: torch.Tensor      # f32[C, 3]
    hi: torch.Tensor      # f32[C, 3]

    @classmethod
    def build(cls, v0, e1, e2, device):
        v0, e1, e2 = (np.asarray(x, np.float32) for x in (v0, e1, e2))
        T = v0.shape[0]
        v1, v2 = v0 + e1, v0 + e2
        tmin = np.minimum(np.minimum(v0, v1), v2)
        tmax = np.maximum(np.maximum(v0, v1), v2)
        cen = (tmin + tmax) * 0.5
        span = np.maximum(cen.max(0) - cen.min(0), 1e-12)
        order = np.argsort(_morton((cen - cen.min(0)) / span), kind="stable")
        C = (T + CHUNK - 1) // CHUNK
        slots = np.full(C * CHUNK, -1, np.int64)
        slots[:T] = order
        slots = slots.reshape(C, CHUNK)
        # lowest id first inside a chunk: argmin's first index then breaks
        # exact ties as the scene order does; the padding goes last
        slots = np.sort(np.where(slots < 0, np.iinfo(np.int64).max, slots), 1)
        slots = np.where(slots == np.iinfo(np.int64).max, -1, slots)
        real = slots >= 0
        safe = np.where(real, slots, 0)
        comps = []
        for arr in (v0, e1, e2):
            for k in range(3):
                x = np.where(real, arr[safe, k], 0.0).astype(np.float32)
                comps.append(torch.from_numpy(x).to(device))
        lo = np.where(real[..., None], tmin[safe], np.inf).min(1) - PAD
        hi = np.where(real[..., None], tmax[safe], -np.inf).max(1) + PAD
        return cls(comps=tuple(comps), ids=torch.from_numpy(slots).to(device),
                   lo=torch.from_numpy(lo.astype(np.float32)).to(device),
                   hi=torch.from_numpy(hi.astype(np.float32)).to(device))


def _pair_tests(ro, rd, tris, t_lower):
    """(t with misses at BIG, u, v) of rays [P, 1] against triangles
    [P, CHUNK], in the renderer's operation order."""
    rox, roy, roz = (ro[:, k:k + 1] for k in range(3))
    rdx, rdy, rdz = (rd[:, k:k + 1] for k in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tris
    hx = rdy * e2z - rdz * e2y
    hy = rdz * e2x - rdx * e2z
    hz = rdx * e2y - rdy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    sx, sy, sz = rox - v0x, roy - v0y, roz - v0z
    u_num = sx * hx + sy * hy + sz * hz
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v_num = rdx * qx + rdy * qy + rdz * qz
    t_num = e2x * qx + e2y * qy + e2z * qz
    ok = torch.abs(a) >= EPS
    f = torch.where(ok, 1.0 / torch.where(ok, a, 1.0), 0.0)
    u, v, t = u_num * f, v_num * f, t_num * f
    valid = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > EPS) & (t > t_lower[:, None]))
    return torch.where(valid, t, BIG), u, v


def closest_hit_plain(tri: ChunkedTriangles, ro, rd, t_lower, alive=None):
    """(hit bool[N], id i32[N], t, u, v f32[N]); a miss or a dead lane is a
    clean miss (all zero)."""
    N, dev = ro.shape[0], ro.device
    best_t = torch.full((N,), BIG, dtype=torch.float32, device=dev)
    best_id = torch.zeros(N, dtype=torch.int64, device=dev)
    best_u = torch.zeros(N, dtype=torch.float32, device=dev)
    best_v = torch.zeros(N, dtype=torch.float32, device=dev)
    live = (torch.arange(N, device=dev) if alive is None
            else alive.nonzero()[:, 0])
    big_id = torch.iinfo(torch.int64).max
    for r0 in range(0, live.shape[0], RAY_BLOCK):
        lanes = live[r0:r0 + RAY_BLOCK]
        o, d = ro[lanes], rd[lanes]
        small = torch.abs(d) < 1e-12
        inv = 1.0 / torch.where(small, torch.where(d < 0, -1e-12, 1e-12), d)
        t0 = (tri.lo[None] - o[:, None]) * inv[:, None]
        t1 = (tri.hi[None] - o[:, None]) * inv[:, None]
        tnear = torch.minimum(t0, t1).amax(-1)
        tfar = torch.maximum(t0, t1).amin(-1)
        crossed = (tfar >= torch.clamp(tnear, min=0.0)) \
            & (tfar > t_lower[lanes][:, None])
        ray_of, chunk_of = crossed.nonzero(as_tuple=True)
        del t0, t1, tnear, tfar, crossed
        n = lanes.shape[0]
        blk_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
        pair_t, pair_id, pair_u, pair_v, pair_ray = [], [], [], [], []
        for p0 in range(0, ray_of.shape[0], PAIR_BLOCK):
            r = ray_of[p0:p0 + PAIR_BLOCK]
            c = chunk_of[p0:p0 + PAIR_BLOCK]
            lane = lanes[r]
            t, u, v = _pair_tests(ro[lane], rd[lane],
                                  tuple(x[c] for x in tri.comps),
                                  t_lower[lane])
            arg = torch.argmin(t, dim=1, keepdim=True)
            pair_t.append(t.gather(1, arg)[:, 0])
            pair_u.append(u.gather(1, arg)[:, 0])
            pair_v.append(v.gather(1, arg)[:, 0])
            pair_id.append(tri.ids[c].gather(1, arg)[:, 0])
            pair_ray.append(r)
        if not pair_t:
            continue
        pt, pu, pv = torch.cat(pair_t), torch.cat(pair_u), torch.cat(pair_v)
        pid, pr = torch.cat(pair_id), torch.cat(pair_ray)
        blk_t = blk_t.scatter_reduce(0, pr, pt, "amin")
        tied = (pt == blk_t[pr]) & (pt < BIG)
        blk_id = torch.full((n,), big_id, dtype=torch.int64, device=dev)
        blk_id = blk_id.scatter_reduce(0, pr[tied], pid[tied], "amin")
        win = tied & (pid == blk_id[pr])
        wr = pr[win]
        got = lanes[wr]
        best_t[got] = pt[win]
        best_id[got] = pid[win]
        best_u[got] = pu[win]
        best_v[got] = pv[win]
    hit = best_t < BIG
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return (hit, torch.where(hit, best_id, 0).to(torch.int32),
            torch.where(hit, best_t, zero), torch.where(hit, best_u, zero),
            torch.where(hit, best_v, zero))

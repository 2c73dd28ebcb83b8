"""Closest-hit queries with stochastic opacity, as
``pbrpathtracer_tpu.ops.hit``: find the closest hit, consult the opacity
texture, and on rejection re-trace past it with an exclusive lower bound on t,
a bounded number of times (``RenderConfig.opacity_attempts``). Draws are keyed
(pixel, sample, stream, slot_base + attempt).

The default intersector routes as the JAX wrapper ``intersect_pallas`` does:
scenes of at most four 512-triangle chunks (2048 triangles) take the dense
kernel (K1), larger ones the BVH kernel (K4); both order the triangles, and
break exact-t ties, by the scene's BVH when it has one. Each wrapper
launches its CUDA kernel for CUDA tensors and takes its plain version for
CPU tensors.

Queries are stop-gradient'd (``hit_vjp="recompute"``): the rays are
detached and the query records no graph, so its outputs carry no gradient
and the kernel never runs in a backward. Shading grafts the winner's
derivatives back on (``ops/shade._winner_straight_through``).
"""

from __future__ import annotations

import torch

from ..kernels.intersect import MAX_DENSE_CHUNKS, dense_chunks, intersect_dense
from ..kernels.intersect_list import intersect_list
from ..scene.scene import Scene
from ..utils.constants import NO_TEXTURE
from . import rng
from .shadepack import UV_OPACITY_FIELDS, build_uv_opacity_pack, gather_fields
from .texture import sample_texture


def default_intersector(scene: Scene, ro, rd, t_lower, alive=None):
    # Rays built from gather_fields' field views inherit their [W, N]
    # strides; the kernels read [N, 3] rows.
    ro, rd = ro.contiguous(), rd.contiguous()
    if dense_chunks(scene.num_triangles) > MAX_DENSE_CHUNKS:
        return intersect_list(scene.geom, ro, rd, t_lower, alive,
                              accel=scene.accel)
    perm = None if scene.accel is None else scene.accel.perm
    return intersect_dense(scene.geom, ro, rd, t_lower, alive, perm=perm)


def interpolate_uv(scene: Scene, tri_idx, u, v):
    """Barycentric UV: (1-u-v)*uv0 + u*uv1 + v*uv2."""
    g = scene.geom
    i = tri_idx.long()
    w0 = (1.0 - u - v)[:, None]
    return w0 * g.uv0[i] + u[:, None] * g.uv1[i] + v[:, None] * g.uv2[i]


@torch.no_grad()
def closest_hit(scene: Scene, cfg, ro, rd, seed, pixel, sample_idx, stream,
                slot_base=rng.SLOT_OPACITY_BASE, intersect_fn=None,
                alive=None):
    """Closest hit with stochastic alpha.

    Returns (hit bool[N], tri_idx i32[N], t f32[N], u f32[N], v f32[N]).
    Shadow rays pass ``slot_base=SLOT_NEE_OPACITY_BASE``. ``alive`` masks
    dead lanes to a clean miss and lets the kernel skip them.
    """
    if intersect_fn is None:
        intersect_fn = default_intersector
    if cfg.opacity_attempts > rng.MAX_OPACITY_ATTEMPTS:
        raise ValueError("opacity_attempts: the draws are one 4-slot group")
    if slot_base % 4 != 0:
        raise ValueError("opacity slot base must be group-aligned")

    ro, rd = ro.detach(), rd.detach()
    N = ro.shape[0]
    t_lower = torch.zeros(N, dtype=torch.float32, device=ro.device)

    hit, idx, t, u, v = intersect_fn(scene, ro, rd, t_lower, alive=alive)
    if not scene.has_opacity_tex:
        return hit, idx, t, u, v

    # A lane is settled once its candidate is a miss, an accepted hit, or
    # has no opacity texture; settled lanes never draw again.
    uvpack = build_uv_opacity_pack(scene)
    draws = rng.rand_slots4(seed, pixel, sample_idx, stream, slot_base // 4)
    result = (hit, idx, t, u, v)
    settled = torch.zeros(N, dtype=torch.bool, device=ro.device)
    ones4 = torch.ones((N, 4), dtype=torch.float32, device=ro.device)
    for attempt in range(cfg.opacity_attempts):
        hit, idx, t, u, v = result
        p_uv0, p_uv1, p_uv2, p_otex = gather_fields(uvpack, idx,
                                                    UV_OPACITY_FIELDS)
        mid = p_otex.to(torch.int32)
        has_otex = hit & (mid != NO_TEXTURE)
        w0 = (1.0 - u - v)[:, None]
        uv = w0 * p_uv0 + u[:, None] * p_uv1 + v[:, None] * p_uv2
        opacity = sample_texture(scene.textures, mid, uv, ones4, has_otex)[:, 0]
        # accept when Rand() < opacity
        rejected = ~settled & has_otex & ~(draws[attempt] < opacity)
        settled = settled | ~rejected
        if attempt == cfg.opacity_attempts - 1:
            break  # budget exhausted: accept the candidate
        t_lower = torch.where(rejected, t, t_lower)
        re_alive = ~settled if alive is None else (alive & ~settled)
        nh, ni, nt, nu, nv = intersect_fn(scene, ro, rd, t_lower,
                                          alive=re_alive)
        result = (torch.where(settled, hit, nh), torch.where(settled, idx, ni),
                  torch.where(settled, t, nt), torch.where(settled, u, nu),
                  torch.where(settled, v, nv))
    return result

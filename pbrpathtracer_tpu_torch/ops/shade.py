"""Wavefront shading: one segment of the reference's recursive Trace() as
branchless masked tensor math, as ``pbrpathtracer_tpu.ops.shade``.

Each call advances every lane by one bounce segment: hit-point setup
(normals, normal map, face-forward), the iter-budget gate, texture overrides,
Russian roulette, lobe selection for OPAQUE and TRANSLUCENT materials,
next-event estimation, and the next ray. Discrete decisions use keyed RNG
slots (ops/rng.py), so the JAX package and its CPU oracle make the same
decisions.

Reference quirks reproduced on purpose:
  * specular-reflection and refraction bounces refund the ``iter`` depth
    budget; only Russian roulette (driven by ``depth``) bounds specular
    chains;
  * Russian roulette uses the *untextured* material diffuse for its survive
    probability and applies no 1/p compensation (``rr_reweight`` enables it);
  * NEE has no 1/r² falloff, no area pdf and no ×num_lights factor
    (``nee_physical`` enables them);
  * the glossy cone basis is built from the reflection vector but the
    degeneracy test reads n.x, and the translucent rough refraction "normal"
    mixes a basis around r with a final axis along n;
  * Schlick's approximation uses (1-c)², not (1-c)⁵.

Two ways to run a segment, one result: on lanes that lie on the card, with
no autograd graph to record, the fused kernels S1-S3 of
``kernels/shade.py`` (``_shade_fused``: one thread a lane, around the K2
fetches and the shadow query) compute the chain bit for bit; everywhere
else, on the CPU and wherever a graph is recorded (a fwd+bwd), the chain
runs as plain torch (``shade_plain``), which is also the kernels' twin.

Gradients (``hit_vjp="recompute"``, the JAX package's default): the hit
queries are stop-gradient'd (``ops/hit.py``), and shading re-derives the
winning triangle's (t, u, v) in closed form and grafts its derivatives onto
the query values (``_winner_straight_through``). The forward values stay
the query's own bit for bit; a render that records no graph skips the
recompute, as XLA drops it from a forward-only JAX graph. Under the other
two modes the query's own (t, u, v) carry the derivative (``ops/hit.py``)
and nothing is grafted, or it would count twice.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels import shade as ks
from ..kernels.packgather import gather_rows_t_fwd
from ..scene.scene import Scene
from ..utils import observability
from ..utils.constants import (
    EPS, FLT_EPSILON, OPAQUE,
    TEX_DIFFUSE, TEX_NORMAL, TEX_EMISSIVE, TEX_ROUGHNESS, TEX_METALLIC,
    NO_TEXTURE,
)
from . import rng, shadepack as sp
from .ggx import ggx_sample
from .linalg import cross, dot, reflect, safe_normalize, safe_sqrt
from .texture import sample_texture

EPS = float(EPS)
FLT_EPSILON = float(FLT_EPSILON)
TWO_PI = float(np.float32(2.0 * np.pi))


@dataclasses.dataclass(frozen=True)
class WavefrontState:
    """Per-lane path state carried across bounce segments."""

    ro: torch.Tensor          # f32[N,3] ray origin
    rd: torch.Tensor          # f32[N,3] ray direction (normalized)
    throughput: torch.Tensor  # f32[N,3] product of BRDF factors so far
    radiance: torch.Tensor    # f32[N,3] accumulated estimate
    alive: torch.Tensor       # bool[N]
    inside: torch.Tensor      # bool[N] inside a dielectric
    itr: torch.Tensor         # i32[N] `iter` depth budget (specular refunds)
    depth: torch.Tensor       # i32[N] true recursion depth (drives RR)
    pixel: torch.Tensor       # i32[N] absolute pixel index (RNG key)

    @classmethod
    def initial(cls, ro, rd, pixel):
        N = ro.shape[0]
        kw = dict(device=ro.device)
        return cls(
            ro=ro, rd=rd,
            throughput=torch.ones((N, 3), dtype=torch.float32, **kw),
            radiance=torch.zeros((N, 3), dtype=torch.float32, **kw),
            alive=torch.ones(N, dtype=torch.bool, **kw),
            inside=torch.zeros(N, dtype=torch.bool, **kw),
            itr=torch.zeros(N, dtype=torch.int32, **kw),
            depth=torch.zeros(N, dtype=torch.int32, **kw),
            pixel=pixel,
        )


_E0_ROWS = {}   # device -> f32[2, 3]: cone_direction's two choices of e0


def _e0_rows(device):
    """The rows (1,0,0) and (1,1,1) on ``device``, made at its first render
    (outside any capture: a graph may read them, never copy them there)."""
    rows = _E0_ROWS.get(device)
    if rows is None:
        with torch.inference_mode(False):
            rows = _E0_ROWS[device] = torch.tensor(
                [[1.0, 0.0, 0.0], [1.0, 1.0, 1.0]], dtype=torch.float32,
                device=device)
    return rows


def cone_direction(basis, last_axis, nx, thresh, w, theta):
    """The reference's hemisphere/cone sampler.

    u = normalize(cross(e0, basis)), v = normalize(cross(u, basis)),
    dir = w cos(2πθ) u + w sin(2πθ) v + sqrt(1-w²) last_axis, normalized.
    ``e0`` is (1,0,0) unless |nx| >= thresh, then (1,1,1); the degeneracy
    test always reads n.x, even when the basis is built around r.
    """
    cond = (torch.abs(nx) < thresh)[:, None]
    rows = _e0_rows(basis.device)
    e0 = torch.where(cond, rows[0], rows[1])
    u = safe_normalize(cross(e0, basis))
    v = safe_normalize(cross(u, basis))
    ang = TWO_PI * theta
    d = (w * torch.cos(ang))[:, None] * u + (w * torch.sin(ang))[:, None] * v \
        + safe_sqrt(1.0 - w * w)[:, None] * last_axis
    return safe_normalize(d)


def direct_illumination(scene: Scene, p, n, diffuse, seed, pixel, sample_idx,
                        stream, shadow_trace, nee_physical: bool,
                        draws=None, alive=None, light_pack=None):
    """Next-event estimation: uniform light pick, (√u, v) area warp, and a
    shadow ray that must first hit the chosen light triangle; contribution
    = L_emit·I · diffuse · dot(n, l). ``nee_physical`` adds the area-measure
    pdf conversion the reference omits: × num_lights × area × cos_light / r².

    ``draws`` optionally supplies the (light-pick, u, v) uniforms (slots
    13-15) when the caller already drew the group. ``light_pack`` is the
    scene's light pack where the caller built it; without it it is built
    here.
    """
    L = scene.num_lights
    if L == 0:
        return torch.zeros_like(p)

    if draws is None:
        _, u_pick, u_su, sv = rng.rand_slots4(seed, pixel, sample_idx, stream,
                                              rng.SLOT_NEE_LIGHT // 4)
    else:
        u_pick, u_su, sv = draws
    lid = torch.clamp(torch.floor(u_pick * L).to(torch.int32), 0, L - 1)
    if light_pack is None:
        light_pack = sp.build_light_pack(scene)
    lv0, le1, le2, lcolor, ltri_f = sp.gather_fields(light_pack, lid,
                                                     sp.LIGHT_FIELDS)
    ltri = ltri_f.to(torch.int32)

    lv1 = lv0 + le1
    lv2 = lv0 + le2
    su = torch.sqrt(u_su)
    w0 = 1.0 - su
    w1 = su * (1.0 - sv)
    w2 = su * sv
    vlight = w0[:, None] * lv0 + w1[:, None] * lv1 + w2[:, None] * lv2

    to_l = vlight - p
    l = safe_normalize(to_l)
    cos_n = dot(n, l)
    facing = cos_n > 0.0  # back-facing samples are rejected before the cast

    # only lanes that survive the outer mask and face the light cast
    sh_alive = None if alive is None else (alive & facing)
    sh_hit, sh_idx, _, _, _ = shadow_trace(p, l, sh_alive)
    visible = ~(sh_hit & (sh_idx != ltri))  # no hit counts as visible

    contrib = lcolor * diffuse * cos_n[:, None]

    if nee_physical:
        c = cross(le1, le2)
        area = 0.5 * torch.sqrt(dot(c, c))
        r2 = torch.clamp(dot(to_l, to_l), min=1e-12)
        ln = safe_normalize(c)
        cos_l = torch.abs(dot(ln, l))
        contrib = contrib * (L * area * cos_l / r2)[:, None] \
            / float(np.float32(np.pi))

    return torch.where((facing & visible)[:, None], contrib, 0.0)


class _Graft(torch.autograd.Function):
    """Straight-through: the forward returns ``orig`` exactly; the backward
    sends the cotangent to ``orig``, and to ``rec`` where ``ok``."""

    @staticmethod
    def forward(ctx, orig, rec, ok):
        ctx.save_for_backward(ok)
        return orig.view_as(orig)

    @staticmethod
    def backward(ctx, cot):
        (ok,) = ctx.saved_tensors
        return cot, torch.where(ok, cot, 0.0), None


def _winner_straight_through(ro, rd, v0, e1, e2, hit, t, bu, bv):
    """Re-derive (t, u, v) for the winning triangle differentiably
    (Möller–Trumbore with the safe-reciprocal guard) and graft the
    derivatives onto the query's values. Misses and degenerate denominators
    keep a zero derivative."""
    h = cross(rd, e2)
    a = dot(e1, h)
    ok = hit & (torch.abs(a) >= EPS)
    f = torch.where(ok, 1.0 / torch.where(ok, a, 1.0), 0.0)
    s = ro - v0
    q = cross(s, e1)
    t_rec = f * dot(e2, q)
    u_rec = f * dot(s, h)
    v_rec = f * dot(rd, q)
    return (_Graft.apply(t, t_rec, ok), _Graft.apply(bu, u_rec, ok),
            _Graft.apply(bv, v_rec, ok))


def shade_segment(scene: Scene, cfg, state: WavefrontState,
                  hit, tri_idx, t, bu, bv,
                  seg, sample_idx, seed, shadow_trace,
                  packs=None) -> WavefrontState:
    """Advance every lane by one bounce segment; returns the new state.
    ``shadow_trace(p, l, alive)`` answers the NEE shadow query. ``packs``
    are the scene's ``shadepack.ScenePacks`` where the caller built them
    (once per sample); without them the tri pack and the light pack are
    built here. Its device time, less the shadow queries, pack builds and
    fetches in it, is the ``pbr.shade`` span's."""
    with observability.device_span("pbr.shade", state.ro.is_cuda):
        if packs is None:
            packs = sp.ScenePacks(
                sp.build_tri_pack(scene),
                sp.build_light_pack(scene) if scene.num_lights else None,
                None)
        return _shade(scene, cfg, state, hit, tri_idx, t, bu, bv, seg,
                      sample_idx, seed, shadow_trace, packs)


def _shade(scene, cfg, state, hit, tri_idx, t, bu, bv, seg, sample_idx,
           seed, shadow_trace, packs):
    """The torch chain, ``shade_plain``, where a graph is recorded
    (something that the segment reads requires grad, and grad mode is on)
    or the lanes lie on the CPU; else the fused kernels."""
    if records_graph(state.ro, state.rd, state.throughput, state.radiance,
                     t, bu, bv, packs.tri, packs.light,
                     scene.textures.data) or not state.ro.is_cuda:
        return shade_plain(scene, cfg, state, hit, tri_idx, t, bu, bv, seg,
                           sample_idx, seed, shadow_trace, packs)
    return _shade_fused(scene, cfg, state, hit, tri_idx, t, bu, bv, seg,
                        sample_idx, seed, shadow_trace, packs)


def records_graph(*inputs) -> bool:
    """Whether a segment over ``inputs`` (tensors, or None) records an
    autograd graph: grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in inputs)


def _lanes(x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise TypeError(f"expected {dtype} {shape}, got {x.dtype} "
                        f"{tuple(x.shape)}")
    return x.contiguous()


def _shade_fused(scene, cfg, state, hit, tri_idx, t, bu, bv, seg,
                 sample_idx, seed, shadow_trace, packs):
    """``shade_plain`` by the kernels of ``kernels/shade.py`` (S1, S2, S3)
    around K2 and the shadow query, bit for bit; each segment shaded counts
    one ``fused_shades``."""
    N = state.ro.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    tex = scene.textures
    L = scene.num_lights
    textured = scene.has_any_texture
    seed_ptr, seed_bytes, seed_val = ks.word(seed)
    sample_ptr, sample_bytes, sample_val = ks.word(sample_idx)
    K, PH, PW, C = tex.data.shape
    n_texels = K * PH * PW
    if textured and (C != 4 or n_texels >= 2 ** 31):
        raise ValueError("the fused texture read takes RGBA stacks of "
                         "under 2**31 texels")
    args = dict(
        ro=_lanes(state.ro, f32, (N, 3)), rd=_lanes(state.rd, f32, (N, 3)),
        tp=_lanes(state.throughput, f32, (N, 3)),
        rad=_lanes(state.radiance, f32, (N, 3)),
        alive=_lanes(state.alive, b8, (N,)),
        inside=_lanes(state.inside, b8, (N,)),
        itr=_lanes(state.itr, i32, (N,)),
        depth=_lanes(state.depth, i32, (N,)),
        # the RNG keys on the pixel's low 32 bits, whatever its int type
        pixel=_lanes(state.pixel.to(i32), i32, (N,)),
        hit=_lanes(hit, b8, (N,)), t=_lanes(t, f32, (N,)),
        bu=_lanes(bu, f32, (N,)), bv=_lanes(bv, f32, (N,)),
        tri=sp.gather_block(packs.tri, tri_idx),
        tex_size=_lanes(tex.size, i32, (K, 2)) if textured else None,
        seed_ptr=seed_ptr, sample_ptr=sample_ptr, n=N, seed_val=seed_val,
        sample_val=sample_val, seed_bytes=seed_bytes,
        sample_bytes=sample_bytes,
        ctr=(rng.bounce_stream(seg) * rng.SLOTS_PER_STREAM) & 0xFFFFFFFF,
        n_lights=L, max_depth=cfg.max_depth, tex_ph=PH, tex_pw=PW,
        n_texels=n_texels,
        flags=((ks.TEXTURED if textured else 0)
               | (ks.GGX if cfg.brdf == "ggx" else 0)
               | (ks.RR_REWEIGHT if cfg.rr_reweight else 0)
               | (ks.NEE_PHYSICAL if cfg.nee_physical else 0)))
    dev = state.ro.device
    empty = functools.partial(torch.empty, device=dev)
    lid = empty(N, dtype=i32) if L else None
    rows = empty(5 * N, dtype=i32) if textured else None
    if L or textured:
        ks.launch("pbr_shade_s1", rows=rows, lid=lid, **args)
    if textured:
        args["texels"] = gather_rows_t_fwd(tex.data.reshape(n_texels, C),
                                           rows)
    if L:
        args["light"] = sp.gather_block(packs.light, lid)
    out = dict(ro_out=empty((N, 3), dtype=f32),
               rd_out=empty((N, 3), dtype=f32),
               tp_out=empty((N, 3), dtype=f32),
               rad_out=empty((N, 3), dtype=f32),
               alive_out=empty(N, dtype=b8), inside_out=empty(N, dtype=b8),
               itr_out=empty(N, dtype=i32), depth_out=empty(N, dtype=i32))
    shadow = {}
    if L:
        shadow = dict(p_sh=empty((N, 3), dtype=f32),
                      l_sh=empty((N, 3), dtype=f32),
                      sh_alive=empty(N, dtype=b8),
                      rad_vis=empty((N, 3), dtype=f32))
    ks.launch("pbr_shade_s2", **args, **out, **shadow)
    if L:
        sh_hit, sh_idx, _, _, _ = shadow_trace(
            shadow["p_sh"], shadow["l_sh"], shadow["sh_alive"])
        ks.launch("pbr_shade_s3", **args, **out, **shadow,
                  sh_hit=_lanes(sh_hit, b8, (N,)),
                  sh_idx=_lanes(sh_idx, i32, (N,)))
    observability.count("fused_shades")
    return WavefrontState(
        ro=out["ro_out"], rd=out["rd_out"], throughput=out["tp_out"],
        radiance=out["rad_out"], alive=out["alive_out"],
        inside=out["inside_out"], itr=out["itr_out"],
        depth=out["depth_out"], pixel=state.pixel)


def shade_plain(scene, cfg, state, hit, tri_idx, t, bu, bv, seg, sample_idx,
                seed, shadow_trace, packs):
    """The segment in plain torch: the CPU path, the path of a call that
    records a graph, and the fused kernels' twin (``_shade_fused``). Reads
    the tri and light packs of ``packs``, as ``_shade_fused`` does."""
    tex = scene.textures
    N = state.ro.shape[0]
    dev = state.ro.device
    stream = rng.bounce_stream(seg)

    # Slots 4-15 are exactly pcg4d groups 1-3: three hashes for the twelve
    # per-segment decisions.
    d_rr, d_lobe_sel, w_l, th_l = rng.rand_slots4(
        seed, state.pixel, sample_idx, stream, rng.SLOT_RR // 4)
    w_rc, th_rc, d_fresnel, d_refl = rng.rand_slots4(
        seed, state.pixel, sample_idx, stream, rng.SLOT_REFRACT_CONE_W // 4)
    d_transl, d_pick, d_nee_u, d_nee_v = rng.rand_slots4(
        seed, state.pixel, sample_idx, stream, rng.SLOT_TRANSLUCENCY // 4)

    active = state.alive & hit
    rd = state.rd

    # One row fetch serves every triangle and material attribute.
    (f_normal, f_n0, f_n1, f_n2, f_uv0, f_uv1, f_uv2, f_smooth,
     f_diffuse, f_specular, f_emissive, f_emiss_int, f_roughness,
     f_reflectiveness, f_transl, f_ior, f_mtype, f_texidx,
     f_tangent, f_bitangent, f_v0, f_e1, f_e2) = sp.gather_fields(
         packs.tri, tri_idx, sp.TRI_FIELDS)

    if cfg.hit_vjp == "recompute" and torch.is_grad_enabled() and any(
            x.requires_grad for x in (state.ro, rd, f_v0, f_e1, f_e2)):
        t, bu, bv = _winner_straight_through(
            state.ro, rd, f_v0, f_e1, f_e2, hit, t, bu, bv)

    p = state.ro + rd * t[:, None]
    w0 = (1.0 - bu - bv)[:, None]
    uv = w0 * f_uv0 + bu[:, None] * f_uv1 + bv[:, None] * f_uv2

    # ---- shading normal ----
    n = f_normal
    smooth_n = safe_normalize(w0 * f_n0 + bu[:, None] * f_n1
                              + bv[:, None] * f_n2)
    n = torch.where((f_smooth != 0.0)[:, None], smooth_n, n)

    zeros4 = torch.zeros((N, 4), dtype=torch.float32, device=dev)
    if scene.has_any_texture:
        tex_idx = f_texidx.to(torch.int32)
        nt_idx = tex_idx[:, TEX_NORMAL]
        has_ntex = active & (nt_idx != NO_TEXTURE)
        texel = sample_texture(tex, nt_idx, uv, zeros4, has_ntex)
        nt = texel[:, :3] * 2.0 - 1.0
        nt = torch.where((nt[:, 2] <= 0.0)[:, None],
                         torch.stack([nt[:, 0], nt[:, 1],
                                      torch.full((N,), EPS, device=dev)],
                                     dim=-1),
                         nt)
        nt = safe_normalize(nt)
        tbn_n = safe_normalize(nt[:, 0:1] * f_tangent
                               + nt[:, 1:2] * f_bitangent
                               + nt[:, 2:3] * n)
        n = torch.where(has_ntex[:, None], tbn_n, n)

    n = torch.where((dot(n, rd) > 0.0)[:, None], -n, n)  # face-forward
    p = p + n * EPS                                       # offset

    # ---- iter-budget gate ----
    active = active & (state.itr < cfg.max_depth)

    # ---- texture overrides ----
    base_diffuse = f_diffuse
    diffuse = base_diffuse
    emiss = f_emissive
    roughness = f_roughness
    reflectiveness = f_reflectiveness
    if scene.has_any_texture:
        def tex_override(slot):
            ti = tex_idx[:, slot]
            has = active & (ti != NO_TEXTURE)
            return has, sample_texture(tex, ti, uv, zeros4, has)
        has_d, tx_d = tex_override(TEX_DIFFUSE)
        diffuse = torch.where(has_d[:, None], tx_d[:, :3], diffuse)
        has_e, tx_e = tex_override(TEX_EMISSIVE)
        emiss = torch.where(has_e[:, None], tx_e[:, :3], emiss)
        has_r, tx_r = tex_override(TEX_ROUGHNESS)
        roughness = torch.where(has_r, tx_r[:, 0], roughness)
        has_m, tx_m = tex_override(TEX_METALLIC)
        reflectiveness = torch.where(has_m, tx_m[:, 0], reflectiveness)

    depth = state.depth + 1   # only consumed by active lanes
    itr = state.itr + 1

    # ---- Russian roulette ----
    prob = torch.clamp(torch.amax(base_diffuse, dim=-1), max=0.95)  # untextured
    rr_active = depth >= cfg.max_depth
    rr_kill = rr_active & (d_rr > prob)
    active = active & ~rr_kill
    if cfg.rr_reweight:
        rr_w = torch.where(rr_active & ~rr_kill,
                           1.0 / torch.clamp(prob, min=1e-6), 1.0)
        throughput = state.throughput * rr_w[:, None]
    else:
        throughput = state.throughput

    # ---- lobe directions ----
    r = reflect(rd, n)
    nx = n[:, 0]
    uniform_dir = cone_direction(n, n, nx, 1.0 - EPS, w_l, th_l)
    glossy_dir = cone_direction(r, r, nx, 1.0 - FLT_EPSILON,
                                w_l * roughness, th_l)
    spec_dir = torch.where((roughness == 1.0)[:, None], uniform_dir,
                           torch.where((roughness == 0.0)[:, None], r,
                                       glossy_dir))

    is_opaque = f_mtype == OPAQUE
    op_spec = is_opaque & (d_lobe_sel < reflectiveness)

    # Optional GGX microfacet lobe for the opaque specular branch
    # (ops/ggx.py): smooth in roughness where the reference cone is hit-flip
    # noise. Translucent reflection keeps the reference lobes.
    spec_weight = None
    if cfg.brdf == "ggx":
        ggx_dir, ggx_w = ggx_sample(rd, n, roughness, w_l, th_l)
        spec_dir = torch.where(op_spec[:, None], ggx_dir, spec_dir)
        spec_weight = torch.where(op_spec, ggx_w, 1.0)

    # ---- translucent decisions ----
    refract_n_cone = cone_direction(r, n, nx, 1.0 - FLT_EPSILON,
                                    w_rc * roughness, th_rc)
    refract_n = torch.where((roughness != 0.0)[:, None], refract_n_cone, n)
    ior = f_ior
    eta = torch.where(state.inside, ior, 1.0 / ior)
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    cth = torch.abs(dot(rd, refract_n))
    k = 1.0 - eta * eta * (1.0 - cth * cth)
    re = r0 + (1.0 - r0) * (1.0 - cth) * (1.0 - cth)  # (1-c)² quirk
    tr_reflect = ~is_opaque & ((k < 0.0)
                               | (d_fresnel < re)
                               | (d_refl < reflectiveness))
    tr_refract = ~is_opaque & ~tr_reflect & (d_transl < f_transl)
    tr_diff = ~is_opaque & ~tr_reflect & ~tr_refract

    refr_dir = safe_normalize(
        eta[:, None] * rd
        - (eta * dot(n, rd) + safe_sqrt(k))[:, None] * refract_n)

    # ---- NEE for diffuse branches ----
    diffuse_branch = (is_opaque & ~op_spec) | tr_diff
    nee = direct_illumination(scene, p, n, diffuse, seed, state.pixel,
                              sample_idx, stream, shadow_trace,
                              cfg.nee_physical,
                              draws=(d_pick, d_nee_u, d_nee_v),
                              alive=active & diffuse_branch,
                              light_pack=packs.light)
    nee = torch.where((active & diffuse_branch)[:, None], nee, 0.0)

    # ---- resolve branches ----
    spec_branch = op_spec | tr_reflect
    new_dir = torch.where(spec_branch[:, None], spec_dir,
                          torch.where(tr_refract[:, None], refr_dir,
                                      uniform_dir))
    tput_factor = torch.where(spec_branch[:, None], f_specular, diffuse)
    if spec_weight is not None:
        tput_factor = tput_factor * spec_weight[:, None]

    emitted = emiss * f_emiss_int[:, None]
    contribution = emitted + nee
    radiance = state.radiance + torch.where(active[:, None],
                                            throughput * contribution, 0.0)
    throughput = torch.where(active[:, None], throughput * tput_factor,
                             throughput)

    # iter refund for specular and refraction bounces
    itr = itr - (spec_branch | tr_refract).to(torch.int32)
    inside = torch.where(active & tr_refract, ~state.inside, state.inside)
    new_ro = torch.where(tr_refract[:, None], p - n * (EPS * 2.0), p)

    return WavefrontState(
        ro=torch.where(active[:, None], new_ro, state.ro),
        rd=torch.where(active[:, None], new_dir, state.rd),
        throughput=throughput,
        radiance=radiance,
        alive=active,
        inside=inside,
        itr=torch.where(active, itr, state.itr),
        depth=torch.where(active, depth, state.depth),
        pixel=state.pixel,
    )

"""Plain PyTorch reference of the path tracer that the benchmark holds the
program against.

A frozen copy of the program's eager render (camera rays, keyed pcg4d
draws, closest hit with the stochastic-opacity re-trace, the wavefront
shading segment with NEE and Russian roulette, accumulation, the L2 pixel
loss and its gradient), written in plain torch operations. It imports
nothing of the program: its closest hit is a brute-force test of every
triangle (``hit.py``), its table fetches are ``index_select``, and it works
out every table it reads (the triangle and light packs, the light list,
the normals and tangents) from the raw scene arrays itself.

Lanes are (pixel, sample) pairs, so any set of pixels of any passes can be
traced at once: every draw is keyed by (seed, pixel, sample, stream, slot),
and a lane's result does not depend on which other lanes run with it.

``prec="bf16"`` is the control: the tables and the wavefront state are
stored in bfloat16 (rounded at every segment), the arithmetic stays in
float32. ``counter`` (a ``Work`` or None) records what each closest-hit
query and table fetch had to do, for the kernels' roofline shares.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hit import ChunkedTriangles, closest_hit_plain

EPS = float(np.float32(1e-5))
FLT_EPSILON = float(np.finfo(np.float32).eps)
TWO_PI = float(np.float32(2.0 * np.pi))
TINY = 1e-12
OPAQUE = 0
TEX_DIFFUSE, TEX_NORMAL, TEX_EMISSIVE, TEX_ROUGHNESS, TEX_METALLIC, \
    TEX_OPACITY = range(6)
NO_TEXTURE = -1
MASK = 0xFFFFFFFF
OPACITY_ATTEMPTS = 4     # the renderer's default re-trace budget
SLOTS_PER_STREAM = 32
SLOT_OPACITY_BASE, SLOT_RR, SLOT_REFRACT_CONE_W, SLOT_TRANSLUCENCY, \
    SLOT_NEE_OPACITY_BASE = 0, 4, 8, 12, 16
MATERIAL_FIELDS = ("diffuse", "specular", "emissive", "emissive_intensity",
                   "roughness", "reflectiveness", "translucency", "ior")
RANGES = {"mat.diffuse": (0.0, 1.0), "mat.specular": (0.0, 1.0),
          "mat.emissive": (0.0, 1.0), "mat.roughness": (0.0, 1.0),
          "mat.reflectiveness": (0.0, 1.0), "mat.translucency": (0.0, 1.0),
          "mat.emissive_intensity": (0.0, None), "mat.ior": (1.0, 3.0),
          "tex.data": (0.0, 1.0)}


# ---------------------------------------------------------------- helpers

def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v)[..., None], min=TINY))


def reflect(rd, n):
    return rd - 2.0 * dot(rd, n)[..., None] * n


def safe_sqrt(x):
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def pcg4d(a, b, c, d, device):
    """The pcg4d hash (Jarzynski & Olano, JCGT 2020) of 32-bit words carried
    in int64: a round of mixing, a xorshift, a round of mixing."""
    def word(v):
        if not isinstance(v, torch.Tensor):
            return torch.tensor(int(v) & MASK, dtype=torch.int64)
        return v.to(device).to(torch.int64) & MASK

    def mix(x, y, z, w):
        x = (x + y * w) & MASK
        y = (y + z * x) & MASK
        z = (z + x * y) & MASK
        w = (w + y * z) & MASK
        return x, y, z, w
    m, k = 1664525, 1013904223
    x, y, z, w = mix(*((word(v) * m + k) & MASK for v in (a, b, c, d)))
    return mix(*(v ^ (v >> 16) for v in (x, y, z, w)))


def draws4(seed, pixel, sample, stream, group):
    """Four uniforms of slots 4*group .. 4*group+3 of (pixel, sample,
    stream, seed); ``pixel`` and ``sample`` are per-lane int tensors."""
    ctr = (stream * SLOTS_PER_STREAM + group * 4) & MASK
    out = pcg4d(pixel, sample, ctr, seed, pixel.device)
    return tuple((x >> 8).to(torch.float32) * (1.0 / 16777216.0) for x in out)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


# ------------------------------------------------------------------ scene

@dataclasses.dataclass
class Scene:
    """The reference's own tables, worked out from the raw arrays."""
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    normal: torch.Tensor
    tangent: torch.Tensor
    bitangent: torch.Tensor
    smoothing: torch.Tensor
    mat_id: torch.Tensor
    mats: dict              # MATERIAL_FIELDS, mat_type, tex_index: tensors
    tex_data: torch.Tensor  # f32[K, PH, PW, 4]
    tex_size: torch.Tensor  # i32[K, 2] (w, h)
    lights: torch.Tensor    # i64[L]
    chunks: ChunkedTriangles
    has_opacity_tex: bool
    has_any_texture: bool

    @property
    def num_triangles(self):
        return self.v0.shape[0]


def _tbn(v0, v1, v2, uv0, uv1, uv2):
    e1, e2 = v1 - v0, v2 - v0
    d1, d2 = uv1 - uv0, uv2 - uv0
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(np.abs(det) > 0, 1.0 / det, 0.0).astype(np.float32)
    tangent = f[:, None] * (d2[:, 1:2] * e1 - d1[:, 1:2] * e2)
    bitangent = f[:, None] * (-d2[:, 0:1] * e1 + d1[:, 0:1] * e2)

    def unit(x):
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return np.where(n > 0, x / np.maximum(n, 1e-30), x).astype(np.float32)
    return unit(np.cross(e1, e2)), unit(tangent), unit(bitangent)


def build_scene(arrays: dict, device) -> Scene:
    """The reference scene from a configuration's raw arrays (``tris``,
    ``materials``, ``textures``): the same numbers the program is given."""
    tris, f32 = arrays["tris"], np.float32
    T = tris["v0"].shape[0]
    v0, v1, v2 = (np.asarray(tris[k], f32) for k in ("v0", "v1", "v2"))
    z2, z3 = np.zeros((T, 2), f32), np.zeros((T, 3), f32)
    uv = [np.asarray(tris.get(k, z2), f32) for k in ("uv0", "uv1", "uv2")]
    normal, tangent, bitangent = _tbn(v0, v1, v2, *uv)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(device)
    specs = arrays["materials"]
    mats = {k: t(np.array([s[k] for s in specs], f32))
            for k in MATERIAL_FIELDS}
    mats["mat_type"] = t(np.array([s["mat_type"] for s in specs]), torch.int32)
    mats["tex_index"] = t(np.array([s["tex_index"] for s in specs]),
                          torch.int32)
    images = arrays["textures"]
    if images:
        ph = max(im.shape[0] for im in images)
        pw = max(im.shape[1] for im in images)
        data = np.zeros((len(images), ph, pw, 4), f32)
        size = np.zeros((len(images), 2), np.int32)
        for k, im in enumerate(images):
            data[k, :im.shape[0], :im.shape[1]] = im
            size[k] = (im.shape[1], im.shape[0])
    else:
        data, size = np.zeros((1, 1, 1, 4), f32), np.ones((1, 2), np.int32)
    mat_id = np.asarray(tris["mat_id"], np.int32)
    emissive = np.array([s["emissive"] for s in specs], f32)
    lights = np.nonzero(np.linalg.norm(emissive[mat_id], axis=-1)
                        >= np.float32(1e-5))[0]
    tex_index = np.array([s["tex_index"] for s in specs])
    return Scene(
        v0=t(v0), e1=t(v1 - v0), e2=t(v2 - v0),
        n0=t(tris.get("n0", z3)), n1=t(tris.get("n1", z3)),
        n2=t(tris.get("n2", z3)),
        uv0=t(uv[0]), uv1=t(uv[1]), uv2=t(uv[2]), normal=t(normal),
        tangent=t(tangent), bitangent=t(bitangent),
        smoothing=t(tris.get("smoothing", np.zeros(T, bool)), torch.bool),
        mat_id=t(mat_id, torch.int64), mats=mats, tex_data=t(data),
        tex_size=t(size, torch.int32), lights=t(lights, torch.int64),
        chunks=ChunkedTriangles.build(v0, v1 - v0, v2 - v0, device),
        has_opacity_tex=bool((tex_index[:, TEX_OPACITY] >= 0).any()),
        has_any_texture=bool((tex_index >= 0).any()))


@dataclasses.dataclass
class Camera:
    pos: torch.Tensor
    dir: torch.Tensor
    up: torch.Tensor
    focal: torch.Tensor
    fovy: torch.Tensor
    focal_dist: torch.Tensor
    aperture: torch.Tensor


def make_camera(spec: dict, device) -> Camera:
    """A camera from its numbers (pos, dir, up, fovy, and optionally focal,
    focal_dist, aperture), direction and up normalised in float32."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32)
    d, u = f32(spec["dir"]), f32(spec.get("up", (0.0, 1.0, 0.0)))
    cam = Camera(pos=f32(spec["pos"]), dir=d / torch.linalg.vector_norm(d),
                 up=u / torch.linalg.vector_norm(u),
                 focal=f32(spec.get("focal", 0.1)), fovy=f32(spec["fovy"]),
                 focal_dist=f32(spec.get("focal_dist", 5.0)),
                 aperture=f32(spec.get("aperture", 0.0)))
    return Camera(**{k: v.to(device) for k, v in vars(cam).items()})


# ------------------------------------------------------------ work counts

class Work:
    """What each query and fetch of a traced render had to do: per closest
    hit the live rays and the hits, per table fetch the ids and the
    distinct rows they name, per fetch backward its ids."""

    def __init__(self):
        self.queries = []    # (live rays, hits)
        self.fetches = []    # (ids, width, distinct rows, table rows)
        self.fetch_bwd = []  # (ids, table rows, width)

    def query(self, alive, hit):
        self.queries.append((int(alive.sum()), int(hit.sum())))

    def fetch(self, table, idx, backward):
        rows = int(torch.unique(idx).numel())
        self.fetches.append((idx.shape[0], table.shape[1], rows,
                             table.shape[0]))
        if backward:
            self.fetch_bwd.append((idx.shape[0], table.shape[0],
                                   table.shape[1]))


# --------------------------------------------------------------- renderer

@dataclasses.dataclass
class Config:
    width: int
    height: int
    max_depth: int
    seed: int
    spp: int = 1             # samples per image of the loss
    prec: str = "fp32"       # "fp32" or the control's "bf16"

    @property
    def n_segments(self):
        return 2 * self.max_depth + 2

    @classmethod
    def of(cls, render: dict, seed: int, prec: str = "fp32") -> "Config":
        """The configuration of a run's render keys (the program's
        ``RenderConfig`` fields); a key that the reference does not
        implement raises, so no run is compared under settings that the
        reference would not follow."""
        known = {"width", "height", "max_depth", "spp"}
        unknown = sorted(set(render) - known)
        if unknown:
            raise ValueError(f"the reference implements no render key "
                             f"{unknown}")
        return cls(seed=seed, prec=prec, **render)


class Renderer:
    """One render of lanes with the materials and textures given (leaves
    that may require grad)."""

    def __init__(self, scene: Scene, camera: Camera, cfg: Config,
                 params: dict | None = None, counter: Work | None = None,
                 count_backward: bool = False):
        """``count_backward``: the counter also counts the backward of the
        fetches from the material tables (a fit of the materials)."""
        self.scene, self.camera, self.cfg = scene, camera, cfg
        self.counter = counter
        self.count_backward = count_backward
        params = params or {}
        self.mats = {k: params.get(f"mat.{k}", scene.mats[k])
                     for k in MATERIAL_FIELDS}
        self.tex = params.get("tex.data", scene.tex_data)
        if cfg.prec == "bf16":
            self.mats = {k: _bf16(v) for k, v in self.mats.items()}
            self.tex = _bf16(self.tex)
        self.tex_flat = self.tex.reshape(-1, 4)
        s = scene
        mid = s.mat_id
        m = self.mats

        def col(x):
            return x.to(torch.float32)[:, None]
        self.tri_pack = torch.cat([
            s.normal, s.n0, s.n1, s.n2, s.uv0, s.uv1, s.uv2, col(s.smoothing),
            m["diffuse"][mid], m["specular"][mid], m["emissive"][mid],
            col(m["emissive_intensity"][mid]), col(m["roughness"][mid]),
            col(m["reflectiveness"][mid]), col(m["translucency"][mid]),
            col(m["ior"][mid]), col(s.mats["mat_type"][mid]),
            s.mats["tex_index"][mid].to(torch.float32),
            s.tangent, s.bitangent, s.v0, s.e1, s.e2], dim=1)
        lt = s.lights
        lmid = mid[lt]
        lcolor = m["emissive"][lmid] * m["emissive_intensity"][lmid][:, None]
        self.light_pack = torch.cat([s.v0[lt], s.e1[lt], s.e2[lt], lcolor,
                                     col(lt)], dim=1)
        if cfg.prec == "bf16":
            self.tri_pack = _bf16(self.tri_pack)
            self.light_pack = _bf16(self.light_pack)
        otex = s.mats["tex_index"][mid, TEX_OPACITY]
        self.uv_pack = torch.cat([s.uv0, s.uv1, s.uv2, col(otex)], dim=1)

    # -- fetches --
    def fetch(self, table, idx, widths):
        if self.counter is not None:
            self.counter.fetch(table, idx, self.count_backward
                               and table is not self.uv_pack)
        rows = table.index_select(0, idx.long())
        return rows.split(widths, dim=1)

    def texture(self, tex_idx, uv, fallback, mask):
        safe = torch.where(mask, tex_idx, 0).long()
        wh = self.scene.tex_size[safe]
        u = torch.remainder(uv[:, 0], 1.0)
        v = torch.remainder(uv[:, 1], 1.0)
        x = (wh[:, 0].to(torch.float32) * u).to(torch.int32)
        y = (wh[:, 1].to(torch.float32) * v).to(torch.int32)
        x = torch.minimum(torch.clamp(x, min=0), wh[:, 0] - 1).long()
        y = torch.minimum(torch.clamp(y, min=0), wh[:, 1] - 1).long()
        _, ph, pw, _ = self.tex.shape
        texel = self.tex_flat.index_select(0, (safe * ph + y) * pw + x)
        return torch.where(mask[:, None], texel, fallback)

    # -- closest hit with the stochastic-opacity re-trace --
    def closest_hit(self, ro, rd, pixel, sample, stream, slot_base, alive):
        ro, rd = ro.detach(), rd.detach()
        N = ro.shape[0]
        t_lower = torch.zeros(N, dtype=torch.float32, device=ro.device)
        with torch.no_grad():
            result = self._query(ro, rd, t_lower, alive)
            if not self.scene.has_opacity_tex:
                return result
            draws = draws4(self.cfg.seed, pixel, sample, stream,
                           slot_base // 4)
            settled = torch.zeros(N, dtype=torch.bool, device=ro.device)
            ones4 = torch.ones((N, 4), dtype=torch.float32, device=ro.device)
            for attempt in range(OPACITY_ATTEMPTS):
                hit, idx, t, u, v = result
                p_uv0, p_uv1, p_uv2, p_otex = self.fetch(self.uv_pack, idx,
                                                         [2, 2, 2, 1])
                mid = p_otex[:, 0].to(torch.int32)
                has = hit & (mid != NO_TEXTURE)
                w0 = (1.0 - u - v)[:, None]
                uv = w0 * p_uv0 + u[:, None] * p_uv1 + v[:, None] * p_uv2
                opacity = self.texture(mid, uv, ones4, has)[:, 0]
                rejected = ~settled & has & ~(draws[attempt] < opacity)
                settled = settled | ~rejected
                if attempt == OPACITY_ATTEMPTS - 1:
                    break
                t_lower = torch.where(rejected, t, t_lower)
                re_alive = ~settled if alive is None else alive & ~settled
                new = self._query(ro, rd, t_lower, re_alive)
                result = tuple(torch.where(settled, a, b)
                               for a, b in zip(result, new))
            return result

    def _query(self, ro, rd, t_lower, alive):
        out = closest_hit_plain(self.scene.chunks, ro, rd, t_lower, alive)
        if self.counter is not None:
            self.counter.query(alive, out[0])
        return out

    # -- one bounce segment --
    def cone(self, basis, last_axis, nx, thresh, w, theta):
        cond = (torch.abs(nx) < thresh)[:, None]
        rows = torch.tensor([[1.0, 0.0, 0.0], [1.0, 1.0, 1.0]],
                            dtype=torch.float32, device=basis.device)
        e0 = torch.where(cond, rows[0], rows[1])
        u = normalize(cross(e0, basis))
        v = normalize(cross(u, basis))
        ang = TWO_PI * theta
        d = (w * torch.cos(ang))[:, None] * u \
            + (w * torch.sin(ang))[:, None] * v \
            + safe_sqrt(1.0 - w * w)[:, None] * last_axis
        return normalize(d)

    def nee(self, p, n, diffuse, pixel, sample, stream, draws, alive):
        L = self.scene.lights.shape[0]
        if L == 0:
            return torch.zeros_like(p)
        u_pick, u_su, sv = draws
        lid = torch.clamp(torch.floor(u_pick * L).to(torch.int32), 0, L - 1)
        lv0, le1, le2, lcolor, ltri_f = self.fetch(self.light_pack, lid,
                                                   [3, 3, 3, 3, 1])
        ltri = ltri_f[:, 0].to(torch.int32)
        lv1, lv2 = lv0 + le1, lv0 + le2
        su = torch.sqrt(u_su)
        w0, w1, w2 = 1.0 - su, su * (1.0 - sv), su * sv
        vlight = w0[:, None] * lv0 + w1[:, None] * lv1 + w2[:, None] * lv2
        l = normalize(vlight - p)
        cos_n = dot(n, l)
        facing = cos_n > 0.0
        sh_hit, sh_idx, _, _, _ = self.closest_hit(
            p, l, pixel, sample, stream, SLOT_NEE_OPACITY_BASE, alive & facing)
        visible = ~(sh_hit & (sh_idx != ltri))
        contrib = lcolor * diffuse * cos_n[:, None]
        return torch.where((facing & visible)[:, None], contrib, 0.0)

    def segment(self, st, seg, sample):
        cfg = self.cfg
        seed, pixel = cfg.seed, st["pixel"]
        stream = 1 + seg
        ro, rd, alive = st["ro"], st["rd"], st["alive"]
        N = ro.shape[0]
        dev = ro.device
        hit, tri_idx, t, bu, bv = self.closest_hit(
            ro, rd, pixel, sample, stream, SLOT_OPACITY_BASE, alive)
        d_rr, d_lobe_sel, w_l, th_l = draws4(seed, pixel, sample, stream,
                                             SLOT_RR // 4)
        w_rc, th_rc, d_fresnel, d_refl = draws4(seed, pixel, sample, stream,
                                                SLOT_REFRACT_CONE_W // 4)
        d_transl, d_pick, d_nee_u, d_nee_v = draws4(
            seed, pixel, sample, stream, SLOT_TRANSLUCENCY // 4)
        active = alive & hit
        (f_normal, f_n0, f_n1, f_n2, f_uv0, f_uv1, f_uv2, f_smooth,
         f_diffuse, f_specular, f_emissive, f_emiss_int, f_roughness,
         f_reflectiveness, f_transl, f_ior, f_mtype, f_texidx,
         f_tangent, f_bitangent, f_v0, f_e1, f_e2) = self.fetch(
             self.tri_pack, tri_idx,
             [3, 3, 3, 3, 2, 2, 2, 1, 3, 3, 3, 1, 1, 1, 1, 1, 1, 6, 3, 3, 3,
              3, 3])
        (f_smooth, f_emiss_int, f_roughness, f_reflectiveness, f_transl,
         f_ior, f_mtype) = (x[:, 0] for x in (
             f_smooth, f_emiss_int, f_roughness, f_reflectiveness, f_transl,
             f_ior, f_mtype))
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (ro, rd, f_v0, f_e1, f_e2)):
            t, bu, bv = winner_straight_through(ro, rd, f_v0, f_e1, f_e2,
                                                hit, t, bu, bv)
        p = ro + rd * t[:, None]
        w0 = (1.0 - bu - bv)[:, None]
        uv = w0 * f_uv0 + bu[:, None] * f_uv1 + bv[:, None] * f_uv2
        n = f_normal
        smooth_n = normalize(w0 * f_n0 + bu[:, None] * f_n1
                             + bv[:, None] * f_n2)
        n = torch.where((f_smooth != 0.0)[:, None], smooth_n, n)
        zeros4 = torch.zeros((N, 4), dtype=torch.float32, device=dev)
        textured = self.scene.has_any_texture
        if textured:
            tex_idx = f_texidx.to(torch.int32)
            nt_idx = tex_idx[:, TEX_NORMAL]
            has_ntex = active & (nt_idx != NO_TEXTURE)
            nt = self.texture(nt_idx, uv, zeros4, has_ntex)[:, :3] * 2.0 - 1.0
            nt = torch.where((nt[:, 2] <= 0.0)[:, None],
                             torch.stack([nt[:, 0], nt[:, 1],
                                          torch.full((N,), EPS, device=dev)],
                                         dim=-1), nt)
            nt = normalize(nt)
            tbn_n = normalize(nt[:, 0:1] * f_tangent + nt[:, 1:2] * f_bitangent
                              + nt[:, 2:3] * n)
            n = torch.where(has_ntex[:, None], tbn_n, n)
        n = torch.where((dot(n, rd) > 0.0)[:, None], -n, n)
        p = p + n * EPS
        active = active & (st["itr"] < cfg.max_depth)
        base_diffuse = f_diffuse
        diffuse, emiss = base_diffuse, f_emissive
        roughness, reflectiveness = f_roughness, f_reflectiveness
        if textured:
            def override(slot):
                ti = tex_idx[:, slot]
                has = active & (ti != NO_TEXTURE)
                return has, self.texture(ti, uv, zeros4, has)
            has_d, tx_d = override(TEX_DIFFUSE)
            diffuse = torch.where(has_d[:, None], tx_d[:, :3], diffuse)
            has_e, tx_e = override(TEX_EMISSIVE)
            emiss = torch.where(has_e[:, None], tx_e[:, :3], emiss)
            has_r, tx_r = override(TEX_ROUGHNESS)
            roughness = torch.where(has_r, tx_r[:, 0], roughness)
            has_m, tx_m = override(TEX_METALLIC)
            reflectiveness = torch.where(has_m, tx_m[:, 0], reflectiveness)
        depth, itr = st["depth"] + 1, st["itr"] + 1
        prob = torch.clamp(torch.amax(base_diffuse, dim=-1), max=0.95)
        rr_kill = (depth >= cfg.max_depth) & (d_rr > prob)
        active = active & ~rr_kill
        throughput = st["throughput"]
        r = reflect(rd, n)
        nx = n[:, 0]
        uniform_dir = self.cone(n, n, nx, 1.0 - EPS, w_l, th_l)
        glossy_dir = self.cone(r, r, nx, 1.0 - FLT_EPSILON, w_l * roughness,
                               th_l)
        spec_dir = torch.where((roughness == 1.0)[:, None], uniform_dir,
                               torch.where((roughness == 0.0)[:, None], r,
                                           glossy_dir))
        is_opaque = f_mtype == OPAQUE
        op_spec = is_opaque & (d_lobe_sel < reflectiveness)
        refract_n_cone = self.cone(r, n, nx, 1.0 - FLT_EPSILON,
                                   w_rc * roughness, th_rc)
        refract_n = torch.where((roughness != 0.0)[:, None], refract_n_cone, n)
        ior = f_ior
        eta = torch.where(st["inside"], ior, 1.0 / ior)
        r0 = (1.0 - ior) / (1.0 + ior)
        r0 = r0 * r0
        cth = torch.abs(dot(rd, refract_n))
        k = 1.0 - eta * eta * (1.0 - cth * cth)
        re = r0 + (1.0 - r0) * (1.0 - cth) * (1.0 - cth)
        tr_reflect = ~is_opaque & ((k < 0.0) | (d_fresnel < re)
                                   | (d_refl < reflectiveness))
        tr_refract = ~is_opaque & ~tr_reflect & (d_transl < f_transl)
        tr_diff = ~is_opaque & ~tr_reflect & ~tr_refract
        refr_dir = normalize(eta[:, None] * rd
                             - (eta * dot(n, rd) + safe_sqrt(k))[:, None]
                             * refract_n)
        diffuse_branch = (is_opaque & ~op_spec) | tr_diff
        nee = self.nee(p, n, diffuse, pixel, sample, stream,
                       (d_pick, d_nee_u, d_nee_v), active & diffuse_branch)
        nee = torch.where((active & diffuse_branch)[:, None], nee, 0.0)
        spec_branch = op_spec | tr_reflect
        new_dir = torch.where(spec_branch[:, None], spec_dir,
                              torch.where(tr_refract[:, None], refr_dir,
                                          uniform_dir))
        tput_factor = torch.where(spec_branch[:, None], f_specular, diffuse)
        contribution = emiss * f_emiss_int[:, None] + nee
        radiance = st["radiance"] + torch.where(
            active[:, None], throughput * contribution, 0.0)
        throughput = torch.where(active[:, None], throughput * tput_factor,
                                 throughput)
        itr = itr - (spec_branch | tr_refract).to(torch.int32)
        inside = torch.where(active & tr_refract, ~st["inside"], st["inside"])
        new_ro = torch.where(tr_refract[:, None], p - n * (EPS * 2.0), p)
        out = dict(ro=torch.where(active[:, None], new_ro, ro),
                   rd=torch.where(active[:, None], new_dir, rd),
                   throughput=throughput, radiance=radiance, alive=active,
                   inside=inside, itr=torch.where(active, itr, st["itr"]),
                   depth=torch.where(active, depth, st["depth"]), pixel=pixel)
        if cfg.prec == "bf16":
            for key in ("ro", "rd", "throughput", "radiance"):
                out[key] = _bf16(out[key])
        return out

    def rays(self, pixel, sample):
        cam, cfg = self.camera, self.cfg
        width, height = cfg.width, cfg.height
        row, col = pixel // width, pixel % width
        img_center = cam.pos + cam.dir * cam.focal
        img_height = 2.0 * cam.focal * torch.tan(
            (cam.fovy / 2.0) * float(np.float32(np.pi)) / 180.0)
        img_width = img_height * float(np.float32(width) / np.float32(height))
        dx, dy = img_width / float(width), img_height / float(height)
        right = cross(cam.up, cam.dir)
        right = right / torch.sqrt(dot(right, right))
        top_left = (img_center - right * (img_width * 0.5)
                    + cam.up * (img_height * 0.5))
        px = (top_left[None, :]
              - cam.up[None, :] * (row.to(torch.float32) * dy)[:, None]
              + right[None, :] * (col.to(torch.float32) * dx)[:, None])
        rd = px - cam.pos[None, :]
        rd = rd / torch.sqrt(dot(rd, rd))[:, None]
        u_angle, u_radius, _, _ = draws4(cfg.seed, pixel, sample, 0, 0)
        angle = u_angle * float(np.float32(2.0 * np.pi))
        radius = torch.sqrt(u_radius)
        disc = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1) \
            * radius[:, None]
        focal_point = cam.pos[None, :] + rd * cam.focal_dist
        ro = (cam.pos[None, :] + right[None, :] * (disc[:, 0:1] * cam.aperture)
              + cam.up[None, :] * (disc[:, 1:2] * cam.aperture))
        rd = focal_point - ro
        return ro, rd / torch.sqrt(dot(rd, rd))[:, None]

    def radiance(self, pixel, sample):
        """f32[N, 3] of the lanes (pixel i32[N], sample i64[N])."""
        ro, rd = self.rays(pixel, sample)
        N, dev = ro.shape[0], ro.device
        st = dict(ro=ro, rd=rd,
                  throughput=torch.ones((N, 3), dtype=torch.float32,
                                        device=dev),
                  radiance=torch.zeros((N, 3), dtype=torch.float32,
                                       device=dev),
                  alive=torch.ones(N, dtype=torch.bool, device=dev),
                  inside=torch.zeros(N, dtype=torch.bool, device=dev),
                  itr=torch.zeros(N, dtype=torch.int32, device=dev),
                  depth=torch.zeros(N, dtype=torch.int32, device=dev),
                  pixel=pixel)
        for seg in range(self.cfg.n_segments):
            if not bool(st["alive"].any()):
                break
            st = self.segment(st, seg, sample)
        return st["radiance"]


class _Graft(torch.autograd.Function):
    """Forward ``orig``; backward to ``orig``, and to ``rec`` where ``ok``."""

    @staticmethod
    def forward(ctx, orig, rec, ok):
        ctx.save_for_backward(ok)
        return orig.view_as(orig)

    @staticmethod
    def backward(ctx, cot):
        (ok,) = ctx.saved_tensors
        return cot, torch.where(ok, cot, 0.0), None


def winner_straight_through(ro, rd, v0, e1, e2, hit, t, bu, bv):
    h = cross(rd, e2)
    a = dot(e1, h)
    ok = hit & (torch.abs(a) >= EPS)
    f = torch.where(ok, 1.0 / torch.where(ok, a, 1.0), 0.0)
    s = ro - v0
    q = cross(s, e1)
    return (_Graft.apply(t, f * dot(e2, q), ok),
            _Graft.apply(bu, f * dot(s, h), ok),
            _Graft.apply(bv, f * dot(rd, q), ok))


# --------------------------------------------------------------- programs

def accumulate_passes(scene, camera, cfg, pixels, n_passes, block=1 << 18,
                      counter=None):
    """Sum over passes 0 .. n_passes-1 of the radiance at ``pixels``
    (i32[n]), added pass after pass as a progressive session adds them:
    f32[n, 3]. Lanes run ``block`` at a time."""
    dev = pixels.device
    n = pixels.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    per_block = max(1, block // n)
    with torch.no_grad():
        r = Renderer(scene, camera, cfg, counter=counter)
        for p0 in range(0, n_passes, per_block):
            k = min(per_block, n_passes - p0)
            samples = torch.arange(p0, p0 + k, device=dev).repeat_interleave(n)
            lanes = pixels.repeat(k)
            rad = r.radiance(lanes, samples).view(k, n, 3)
            for j in range(k):
                acc = acc + rad[j]
    return acc


def render_image(scene, camera, cfg, sample, params=None, counter=None,
                 block=1 << 18, count_backward=False):
    """One sample over the whole image, f32[H*W, 3], in blocks of lanes:
    differentiable w.r.t. ``params`` where they require grad."""
    dev = scene.v0.device
    n = cfg.width * cfg.height
    r = Renderer(scene, camera, cfg, params, counter, count_backward)
    out = []
    for p0 in range(0, n, block):
        pixel = torch.arange(p0, min(n, p0 + block), dtype=torch.int32,
                             device=dev)
        samples = torch.full(pixel.shape, sample, dtype=torch.int64,
                             device=dev)
        out.append(r.radiance(pixel, samples))
    return torch.cat(out)


def loss_and_grad(scene, camera, cfg, target, params, counter=None,
                  count_backward=False, keep=None):
    """(loss, grads) of the mean squared error of the image of ``cfg.spp``
    samples, seed ``cfg.seed``, against ``target`` f32[H, W, 3]. ``keep``
    (a slice of the pixels, row-major) takes the mean over those alone."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    with torch.enable_grad():
        acc = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                          device=target.device)
        for sample in range(cfg.spp):
            acc = acc + render_image(scene, camera, cfg, sample, leaves,
                                     counter, count_backward=count_backward)
        img = (acc / float(cfg.spp)).reshape(cfg.height, cfg.width, 3)
        err = (img - target) ** 2
        if keep is not None:
            err = err.reshape(-1, 3)[keep]
        loss = torch.mean(err)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def fit_params(scene, materials=True, textures=False):
    params = {}
    if materials:
        params.update({f"mat.{k}": scene.mats[k] for k in MATERIAL_FIELDS})
    if textures:
        params["tex.data"] = scene.tex_data
    return {k: params[k] for k in sorted(params)}


def fit_steps(scene, camera, cfg, target, params, steps, lr, seed,
              keep_grads=(0,), keep_params=(), counters=None,
              count_backward=False, loss_fn=None):
    """The first ``steps`` steps of the fit: Adam (lr) on the sorted
    parameters, the clip into their ranges after each step, step s seeded
    ``seed + s``. Returns (losses, {s: the gradients of step s} for s in
    ``keep_grads``, {n: the parameters after n steps} for n in
    ``keep_params``). ``counters`` {step: Work} count the work of those
    steps' forwards; ``loss_fn`` stands in for ``loss_and_grad``."""
    loss_fn = loss_fn or loss_and_grad
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr)
    losses, grads_at, kept = [], {}, {}
    if 0 in keep_params:
        kept[0] = {k: v.detach().clone() for k, v in leaves.items()}
    for s in range(steps):
        step_cfg = dataclasses.replace(cfg, seed=seed + s)
        loss, grads = loss_fn(scene, camera, step_cfg, target, leaves,
                              counter=(counters or {}).get(s),
                              count_backward=count_backward)
        if s in keep_grads:
            grads_at[s] = {k: g.detach().clone() for k, g in grads.items()}
        for k, p in leaves.items():
            p.grad = grads[k]
        opt.step()
        with torch.no_grad():
            for k, p in leaves.items():
                lo, hi = RANGES.get(k, (None, None))
                p.copy_(torch.clamp(p, lo, hi))
        losses.append(float(loss))
        if s + 1 in keep_params:
            kept[s + 1] = {k: v.detach().clone() for k, v in leaves.items()}
    return losses, grads_at, kept

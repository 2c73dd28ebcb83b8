// The fused forward shading segment for Hopper (sm_90a): S1, S2 and S3.
//
// Replaces no TPU kernel: the JAX package leaves shading to XLA, which fuses
// the chain of ops/shade.py into a few loops. The port ran it as ~790 torch
// kernels a segment, one per elementwise operation over every lane. These
// three kernels compute the same segment, one thread per lane with its state
// in registers, around the existing gathers (K2) and the shadow query (K1 or
// K4), as ops/shade.shade_segment launches them:
//   1. K2 fetches the tri pack rows (field-major [55, N]);
//   2. S1: the light id (NEE's pick) and, in a textured scene, the texel
//      rows of the five texture slots a hit reads ([5 N]);
//   3. K2 gathers the texels ([4, 5 N]) and the light rows ([13, N]);
//   4. S2: normals, the normal map, face-forward, the iter gate, the texture
//      overrides, Russian roulette, the cone / mirror / refraction / GGX
//      lobes, Fresnel and the translucent decisions, NEE's area warp and
//      cosine; the new state, the shadow ray and its mask, and the radiance
//      that a visible light would give;
//   5. the shadow query;
//   6. S3: the radiance of the lanes whose light is visible.
//
// What bounds it: device memory. A live lane reads its state (62 B), its hit
// (17 B), its tri-pack row (220 B), its light row (52 B) and its texels
// (80 B, textured scenes) once and writes its new state, the shadow ray and
// a 12-byte stash: about 0.55-0.62 KB a lane, 0.14 ms a segment of 786,432
// lanes at 3.35 TB/s. Every field-major row is read coalesced; a dead lane
// reads its flags and copies its state.
//
// Numerics: bit for bit the torch chain of ops/shade.shade_plain on the card.
// Built with --fmad=false and without fast math, so every operation rounds
// on its own, in the torch chain's order; the same device functions as
// torch's CUDA kernels (rsqrtf for torch.rsqrt, IEEE sqrtf and division,
// cosf / sinf, floorf, torch.remainder's fmodf form); constants rounded from
// the double that torch receives; a division by a Python float is torch's
// multiplication by the float reciprocal; x / tensor from a Python float is
// torch's reciprocal times x. The pcg4d words are uint32, equal to the int64
// words masked with 0xFFFFFFFF of ops/rng.py.

#include <cuda_runtime.h>
#include <stdint.h>

// One struct for the three kernels' arguments, all fields 8 bytes wide, in
// the order of kernels/shade.py's ``_ARGS``.
struct ShadeArgs {
  // ---- inputs ----
  const float* ro;        // f32[N, 3] state
  const float* rd;
  const float* tp;
  const float* rad;
  const uint8_t* alive;   // bool[N]
  const uint8_t* inside;
  const int* itr;         // i32[N]
  const int* depth;
  const int* pixel;
  const uint8_t* hit;     // the segment's closest hit
  const float* t;
  const float* bu;
  const float* bv;
  const float* tri;       // f32[55, N]: K2's tri-pack rows
  const float* light;     // f32[13, N]: K2's light rows (null: no lights)
  const float* texels;    // f32[4, 5 N]: K2's texels (null: untextured)
  const int* tex_size;    // i32[K, 2] (width, height)
  const void* seed_ptr;   // 0-d device word, or null: seed_val
  const void* sample_ptr; // 0-d device word, or null: sample_val
  const uint8_t* sh_hit;  // the shadow query (S3)
  const int* sh_idx;
  // ---- outputs ----
  int* rows;              // i32[5 N] texel rows (S1, textured)
  int* lid;               // i32[N] light ids (S1, lights)
  float* ro_out;          // the new state
  float* rd_out;
  float* tp_out;
  float* rad_out;
  uint8_t* alive_out;
  uint8_t* inside_out;
  int* itr_out;
  int* depth_out;
  float* p_sh;            // f32[N, 3] shadow ray origin and direction
  float* l_sh;
  uint8_t* sh_alive;      // bool[N]: the lanes that cast a shadow ray
  float* rad_vis;         // f32[N, 3]: the radiance if the light is visible
  // ---- scalars ----
  long long n;
  long long seed_val;
  long long sample_val;
  long long seed_bytes;   // 4 or 8: the width of *seed_ptr
  long long sample_bytes;
  long long ctr;          // stream * 32, masked to 32 bits
  long long n_lights;
  long long max_depth;
  long long tex_ph;       // the texture stack's padded height and width
  long long tex_pw;
  long long n_texels;     // K * PH * PW: the zero row of the texel table
  long long flags;        // kTextured | kGgx | kRrReweight | kNeePhysical
};

namespace {

constexpr int kThreads = 128;

constexpr long long kTextured = 1, kGgx = 2, kRrReweight = 4,
                    kNeePhysical = 8;

// ops/shadepack.py's tri-pack and light-pack columns
constexpr int kNormal = 0, kN0 = 3, kN1 = 6, kN2 = 9, kUV0 = 12, kUV1 = 14,
              kUV2 = 16, kSmooth = 18, kDiffuse = 19, kSpecular = 22,
              kEmissive = 25, kEmissInt = 28, kRoughness = 29,
              kReflectiveness = 30, kTranslucency = 31, kIor = 32,
              kMatType = 33, kTexIdx = 34, kTangent = 40, kBitangent = 43;
constexpr int kLV0 = 0, kLE1 = 3, kLE2 = 6, kLColor = 9, kLTri = 12;
// utils/constants.py's texture slots; S1 writes the rows of these five, in
// this order
constexpr int kTexDiffuse = 0, kTexNormal = 1, kTexEmissive = 2,
              kTexRoughness = 3, kTexMetallic = 4;
constexpr int kNoTexture = -1;

__device__ __forceinline__ int slot_of(int s) {
  return s == 0 ? kTexNormal : s == 1 ? kTexDiffuse : s == 2 ? kTexEmissive
         : s == 3 ? kTexRoughness : kTexMetallic;
}

// Constants as torch receives them: a Python float (a double) rounded to
// float32.
constexpr float kEps = (float)1e-5;                 // np.float32(1e-5)
constexpr float kEps2 = (float)((double)kEps * 2.0);
constexpr float kFltEpsilon = 1.1920928955078125e-07f;
constexpr float kThreshN = (float)(1.0 - (double)kEps);
constexpr float kThreshF = (float)(1.0 - (double)kFltEpsilon);
constexpr float kTwoPi = (float)6.283185307179586;  // np.float32(2 pi)
constexpr float kPi = (float)3.141592653589793;     // np.float32(pi)
constexpr float kTiny = (float)1e-12;               // ops/linalg.TINY
constexpr float kRrMax = (float)0.95;
constexpr float kRrMin = (float)1e-6;
constexpr float kMinAlpha = (float)1e-4;            // ops/ggx.MIN_ALPHA
constexpr float kGgxFloor = (float)1e-12;
constexpr float kSmithFloor = (float)1e-8;
constexpr float kUnit = (float)(1.0 / 16777216.0);  // ops/rng._to_unit

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}

__device__ __forceinline__ V3 load3(const float* a, long long i) {
  return v3(a[3 * i], a[3 * i + 1], a[3 * i + 2]);
}

__device__ __forceinline__ void store3(float* a, long long i, V3 v) {
  a[3 * i] = v.x;
  a[3 * i + 1] = v.y;
  a[3 * i + 2] = v.z;
}

// column `col` of a field-major [W, N] block
__device__ __forceinline__ float col(const float* b, int c, long long n,
                                     long long i) {
  return b[c * n + i];
}

__device__ __forceinline__ V3 col3(const float* b, int c, long long n,
                                   long long i) {
  return v3(b[c * n + i], b[(c + 1) * n + i], b[(c + 2) * n + i]);
}

// ops/linalg.py
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}

__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }

// torch.clamp(x, min=lo) and (x, max=hi): NaN passes
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ V3 safe_normalize(V3 v) {
  const float r = rsqrtf(clamp_min(dot(v, v), kTiny));
  return scale(v, r);
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

__device__ __forceinline__ V3 reflect(V3 rd, V3 n) {
  return sub(rd, scale(n, 2.0f * dot(rd, n)));
}

// torch.remainder(x, 1.0)
__device__ __forceinline__ float remainder1(float a) {
  float mod = fmodf(a, 1.0f);
  if (mod != 0.0f && mod < 0.0f) mod += 1.0f;
  return mod;
}

// ---- ops/rng.py ----

__device__ __forceinline__ uint32_t word(const void* p, long long bytes,
                                         long long val) {
  if (p == nullptr) return (uint32_t)val;
  return bytes == 8 ? (uint32_t)(*(const long long*)p)
                    : (uint32_t)(*(const int*)p);
}

struct Draws {
  float a, b, c, d;
};

__device__ __forceinline__ float to_unit(uint32_t x) {
  return (float)(x >> 8) * kUnit;
}

// rand_slots4: one pcg4d of (pixel, sample, ctr, seed)
__device__ __forceinline__ Draws rand4(uint32_t pixel, uint32_t sample,
                                       uint32_t ctr, uint32_t seed) {
  const uint32_t m = 1664525u, k = 1013904223u;
  uint32_t x = pixel * m + k, y = sample * m + k, z = ctr * m + k,
           w = seed * m + k;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  Draws r;
  r.a = to_unit(x);
  r.b = to_unit(y);
  r.c = to_unit(z);
  r.d = to_unit(w);
  return r;
}

struct Keys {
  uint32_t pixel, sample, ctr, seed;
  __device__ Draws group(uint32_t g) const {
    return rand4(pixel, sample, ctr + 4u * g, seed);
  }
};

__device__ __forceinline__ Keys keys(const ShadeArgs& a, long long i) {
  Keys k;
  k.pixel = (uint32_t)a.pixel[i];
  k.sample = word(a.sample_ptr, a.sample_bytes, a.sample_val);
  k.ctr = (uint32_t)a.ctr;
  k.seed = word(a.seed_ptr, a.seed_bytes, a.seed_val);
  return k;
}

// ---- ops/shade.cone_direction ----
__device__ V3 cone_direction(V3 basis, V3 last_axis, float nx, float thresh,
                             float w, float theta) {
  const bool cond = fabsf(nx) < thresh;
  const V3 e0 = cond ? v3(1.0f, 0.0f, 0.0f) : v3(1.0f, 1.0f, 1.0f);
  const V3 u = safe_normalize(cross(e0, basis));
  const V3 v = safe_normalize(cross(u, basis));
  const float ang = theta * kTwoPi;
  const float ca = w * cosf(ang);
  const float sa = w * sinf(ang);
  const float c = safe_sqrt(1.0f - w * w);
  return safe_normalize(
      add(add(scale(u, ca), scale(v, sa)), scale(last_axis, c)));
}

// ---- ops/ggx.py ----
__device__ __forceinline__ float smith_g1(float cos_x, float alpha) {
  const float a2 = alpha * alpha;
  const float c = fabsf(cos_x);
  return 2.0f * c /
         clamp_min(c + safe_sqrt(a2 + (1.0f - a2) * c * c), kSmithFloor);
}

__device__ void ggx_sample(V3 rd, V3 n, float roughness, float u1, float u2,
                           V3* l_out, float* w_out) {
  const float alpha = clamp_min(roughness * roughness, kMinAlpha);
  const float a2 = alpha * alpha;
  const float c2 = (1.0f - u1) / clamp_min(1.0f + (a2 - 1.0f) * u1, kGgxFloor);
  const float cos_h = safe_sqrt(c2);
  const float sin_h = safe_sqrt(1.0f - c2);
  const float phi = u2 * kTwoPi;
  // orthonormal_basis(n)
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = (1.0f / (s + n.z)) * -1.0f;
  const float c = n.x * n.y * a;
  const V3 t = v3(1.0f + s * n.x * n.x * a, s * c, -s * n.x);
  const V3 b = v3(c, s + n.y * n.y * a, -n.y);
  const float hs = sin_h * cosf(phi);
  const float hb = sin_h * sinf(phi);
  const V3 h = safe_normalize(add(add(scale(t, hs), scale(b, hb)),
                                  scale(n, cos_h)));
  const V3 v = neg(rd);
  const V3 l = reflect(rd, h);
  const float cos_v = dot(n, v);
  const float cos_l = dot(n, l);
  const float vh = dot(v, h);
  const float nh = dot(n, h);
  const float g2 = smith_g1(cos_v, alpha) * smith_g1(cos_l, alpha);
  const float w = g2 * vh / clamp_min(cos_v * nh, kSmithFloor);
  const bool ok = cos_l > 0.0f && cos_v > 0.0f && vh > 0.0f;
  *l_out = l;
  *w_out = ok ? w : 0.0f;
}

// ---- ops/texture.sample_texture's row of texture `ti` at `uv` ----
__device__ __forceinline__ int texel_row(const ShadeArgs& a, int ti, float u,
                                         float v) {
  const int w = a.tex_size[2 * ti], h = a.tex_size[2 * ti + 1];
  int x = (int)((float)w * remainder1(u));
  int y = (int)((float)h * remainder1(v));
  x = min(max(x, 0), w - 1);
  y = min(max(y, 0), h - 1);
  return (ti * (int)a.tex_ph + y) * (int)a.tex_pw + x;
}

__device__ __forceinline__ V3 bary(V3 a, V3 b, V3 c, float w0, float bu,
                                   float bv) {
  return add(add(scale(a, w0), scale(b, bu)), scale(c, bv));
}

// S1: the light pick and the texel rows.
__global__ void __launch_bounds__(kThreads) shade_s1_kernel(ShadeArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = a.n;
  if (i >= n) return;
  const bool active0 = a.alive[i] != 0 && a.hit[i] != 0;
  const bool active1 = active0 && a.itr[i] < a.max_depth;
  if (a.lid != nullptr) {
    // only the lanes that may cast a shadow ray read their light row
    int lid = -1;
    if (active1) {
      const Draws g3 = keys(a, i).group(3);
      const int L = (int)a.n_lights;
      lid = (int)floorf(g3.b * (float)L);
      lid = min(max(lid, 0), L - 1);
    }
    a.lid[i] = lid;
  }
  if (a.rows == nullptr) return;
  int rows[5];
  const int none = (int)a.n_texels;
  for (int s = 0; s < 5; ++s) rows[s] = none;
  if (active0) {
    const float bu = a.bu[i], bv = a.bv[i];
    const float w0 = 1.0f - bu - bv;
    const float u = w0 * col(a.tri, kUV0, n, i) + bu * col(a.tri, kUV1, n, i) +
                    bv * col(a.tri, kUV2, n, i);
    const float v = w0 * col(a.tri, kUV0 + 1, n, i) +
                    bu * col(a.tri, kUV1 + 1, n, i) +
                    bv * col(a.tri, kUV2 + 1, n, i);
    for (int s = 0; s < 5; ++s) {
      if (s > 0 && !active1) break;   // the overrides pass the iter gate
      const int ti = (int)col(a.tri, kTexIdx + slot_of(s), n, i);
      if (ti != kNoTexture) rows[s] = texel_row(a, ti, u, v);
    }
  }
  for (int s = 0; s < 5; ++s) a.rows[s * n + i] = rows[s];
}

// S2: the segment up to the shadow query.
__global__ void __launch_bounds__(kThreads) shade_s2_kernel(ShadeArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = a.n;
  if (i >= n) return;
  const bool alive = a.alive[i] != 0;
  const bool inside = a.inside[i] != 0;
  const int itr = a.itr[i], depth = a.depth[i];
  const bool active1 = alive && a.hit[i] != 0 && itr < a.max_depth;
  const V3 tp = load3(a.tp, i);
  const V3 rad = load3(a.rad, i);
  const bool rr_reweight = (a.flags & kRrReweight) != 0;
  const bool lights = a.light != nullptr;

  // Russian roulette reads the untextured diffuse and the depth budget on
  // every lane: with rr_reweight the throughput of a lane that is not
  // active still takes its weight
  const Keys key = keys(a, i);
  const Draws g1 = (active1 || rr_reweight) ? key.group(1) : Draws{};
  const int depth1 = depth + 1;
  float prob = 0.0f;
  bool rr_kill = false;
  V3 tp_rr = tp;
  if (active1 || rr_reweight) {
    const V3 bd = col3(a.tri, kDiffuse, n, i);
    float m = (isnan(bd.x) || bd.x > bd.y) ? bd.x : bd.y;
    m = (isnan(m) || m > bd.z) ? m : bd.z;
    prob = clamp_max(m, kRrMax);
    const bool rr_active = depth1 >= a.max_depth;
    rr_kill = rr_active && g1.a > prob;
    if (rr_reweight) {
      const float rr_w = (rr_active && !rr_kill)
                             ? (1.0f / clamp_min(prob, kRrMin)) * 1.0f
                             : 1.0f;
      tp_rr = scale(tp, rr_w);
    }
  }

  if (!active1 || rr_kill) {
    // torch.where leaves every field of such a lane but these two
    store3(a.ro_out, i, load3(a.ro, i));
    store3(a.rd_out, i, load3(a.rd, i));
    store3(a.tp_out, i, tp_rr);
    store3(a.rad_out, i, add(rad, v3(0.0f, 0.0f, 0.0f)));
    a.alive_out[i] = 0;
    a.inside_out[i] = inside ? 1 : 0;
    a.itr_out[i] = itr;
    a.depth_out[i] = depth;
    if (lights) a.sh_alive[i] = 0;
    return;
  }

  const Draws g2 = key.group(2);
  const Draws g3 = key.group(3);
  const float d_lobe_sel = g1.b, w_l = g1.c, th_l = g1.d;
  const float w_rc = g2.a, th_rc = g2.b, d_fresnel = g2.c, d_refl = g2.d;
  const float d_transl = g3.a, d_nee_u = g3.c, d_nee_v = g3.d;

  const V3 ro = load3(a.ro, i);
  const V3 rd = load3(a.rd, i);
  const float t = a.t[i], bu = a.bu[i], bv = a.bv[i];
  const float* F = a.tri;

  V3 p = add(ro, scale(rd, t));
  const float w0 = 1.0f - bu - bv;

  // ---- shading normal ----
  V3 nrm = col3(F, kNormal, n, i);
  if (col(F, kSmooth, n, i) != 0.0f)
    nrm = safe_normalize(bary(col3(F, kN0, n, i), col3(F, kN1, n, i),
                              col3(F, kN2, n, i), w0, bu, bv));

  const bool textured = (a.flags & kTextured) != 0;
  V3 diffuse = col3(F, kDiffuse, n, i);
  V3 emiss = col3(F, kEmissive, n, i);
  float roughness = col(F, kRoughness, n, i);
  float reflectiveness = col(F, kReflectiveness, n, i);
  if (textured) {
    const long long n5 = 5 * n;
    const float* T = a.texels;
    // slot s's texel, channel c
#define TEXEL(s, c) T[(c) * n5 + (s) * n + i]
    const int ti_n = (int)col(F, kTexIdx + kTexNormal, n, i);
    if (ti_n != kNoTexture) {
      V3 nt = v3(TEXEL(0, 0) * 2.0f - 1.0f, TEXEL(0, 1) * 2.0f - 1.0f,
                 TEXEL(0, 2) * 2.0f - 1.0f);
      if (nt.z <= 0.0f) nt.z = kEps;
      nt = safe_normalize(nt);
      nrm = safe_normalize(add(add(scale(col3(F, kTangent, n, i), nt.x),
                                   scale(col3(F, kBitangent, n, i), nt.y)),
                               scale(nrm, nt.z)));
    }
    if ((int)col(F, kTexIdx + kTexDiffuse, n, i) != kNoTexture)
      diffuse = v3(TEXEL(1, 0), TEXEL(1, 1), TEXEL(1, 2));
    if ((int)col(F, kTexIdx + kTexEmissive, n, i) != kNoTexture)
      emiss = v3(TEXEL(2, 0), TEXEL(2, 1), TEXEL(2, 2));
    if ((int)col(F, kTexIdx + kTexRoughness, n, i) != kNoTexture)
      roughness = TEXEL(3, 0);
    if ((int)col(F, kTexIdx + kTexMetallic, n, i) != kNoTexture)
      reflectiveness = TEXEL(4, 0);
#undef TEXEL
  }

  if (dot(nrm, rd) > 0.0f) nrm = neg(nrm);   // face-forward
  p = add(p, scale(nrm, kEps));               // offset

  // ---- lobes ----
  const V3 r = reflect(rd, nrm);
  const float nx = nrm.x;
  const V3 uniform_dir = cone_direction(nrm, nrm, nx, kThreshN, w_l, th_l);
  const bool is_opaque = col(F, kMatType, n, i) == 0.0f;
  const bool op_spec = is_opaque && d_lobe_sel < reflectiveness;

  bool tr_reflect = false, tr_refract = false, tr_diff = false;
  V3 refr_dir = uniform_dir;
  bool inside_out = inside;
  if (!is_opaque) {
    V3 refract_n = nrm;
    if (roughness != 0.0f)
      refract_n = cone_direction(r, nrm, nx, kThreshF, w_rc * roughness,
                                 th_rc);
    const float ior = col(F, kIor, n, i);
    const float eta = inside ? ior : (1.0f / ior) * 1.0f;
    float r0 = (1.0f - ior) / (ior + 1.0f);
    r0 = r0 * r0;
    const float cth = fabsf(dot(rd, refract_n));
    const float k = 1.0f - eta * eta * (1.0f - cth * cth);
    const float re = r0 + (1.0f - r0) * (1.0f - cth) * (1.0f - cth);
    tr_reflect = k < 0.0f || d_fresnel < re || d_refl < reflectiveness;
    tr_refract = !tr_reflect && d_transl < col(F, kTranslucency, n, i);
    tr_diff = !tr_reflect && !tr_refract;
    if (tr_refract) {
      refr_dir = safe_normalize(
          sub(scale(rd, eta),
              scale(refract_n, eta * dot(nrm, rd) + safe_sqrt(k))));
      inside_out = !inside;
    }
  }
  const bool spec_branch = op_spec || tr_reflect;
  const bool diffuse_branch = (is_opaque && !op_spec) || tr_diff;

  V3 new_dir = uniform_dir;
  V3 tput_factor = diffuse;
  if (spec_branch) {
    tput_factor = col3(F, kSpecular, n, i);
    if ((a.flags & kGgx) != 0 && op_spec) {
      float w;
      ggx_sample(rd, nrm, roughness, w_l, th_l, &new_dir, &w);
      tput_factor = scale(tput_factor, w);
    } else if (roughness == 1.0f) {
      new_dir = uniform_dir;
    } else if (roughness == 0.0f) {
      new_dir = r;
    } else {
      new_dir = cone_direction(r, r, nx, kThreshF, w_l * roughness, th_l);
    }
  } else if (tr_refract) {
    new_dir = refr_dir;
  }

  // ---- next-event estimation (direct_illumination) ----
  const V3 emitted = scale(emiss, col(F, kEmissInt, n, i));
  bool cast = false;
  V3 contrib = v3(0.0f, 0.0f, 0.0f);
  if (lights && diffuse_branch) {
    const float* Lr = a.light;
    const V3 lv0 = col3(Lr, kLV0, n, i);
    const V3 le1 = col3(Lr, kLE1, n, i);
    const V3 le2 = col3(Lr, kLE2, n, i);
    const V3 lv1 = add(lv0, le1);
    const V3 lv2 = add(lv0, le2);
    const float su = sqrtf(d_nee_u);
    const float lw0 = 1.0f - su;
    const float lw1 = su * (1.0f - d_nee_v);
    const float lw2 = su * d_nee_v;
    const V3 vlight = add(add(scale(lv0, lw0), scale(lv1, lw1)),
                          scale(lv2, lw2));
    const V3 to_l = sub(vlight, p);
    const V3 l = safe_normalize(to_l);
    const float cos_n = dot(nrm, l);
    cast = cos_n > 0.0f;   // back-facing samples cast no ray
    if (cast) {
      contrib = scale(mul(col3(Lr, kLColor, n, i), diffuse), cos_n);
      if ((a.flags & kNeePhysical) != 0) {
        const V3 c = cross(le1, le2);
        const float area = 0.5f * sqrtf(dot(c, c));
        const float r2 = clamp_min(dot(to_l, to_l), kTiny);
        const V3 ln = safe_normalize(c);
        const float cos_l = fabsf(dot(ln, l));
        const float f = (float)a.n_lights * area * cos_l / r2;
        const float inv_pi = 1.0f / kPi;
        contrib = scale(scale(contrib, f), inv_pi);
      }
      store3(a.p_sh, i, p);
      store3(a.l_sh, i, l);
      store3(a.rad_vis, i, add(rad, mul(tp_rr, add(emitted, contrib))));
    }
  }
  if (lights) a.sh_alive[i] = cast ? 1 : 0;

  // the radiance if no light is seen; S3 writes rad_vis where one is
  store3(a.rad_out, i,
         add(rad, mul(tp_rr, add(emitted, v3(0.0f, 0.0f, 0.0f)))));
  store3(a.tp_out, i, mul(tp_rr, tput_factor));
  store3(a.ro_out, i, tr_refract ? sub(p, scale(nrm, kEps2)) : p);
  store3(a.rd_out, i, new_dir);
  a.alive_out[i] = 1;
  a.inside_out[i] = inside_out ? 1 : 0;
  a.itr_out[i] = itr + 1 - ((spec_branch || tr_refract) ? 1 : 0);
  a.depth_out[i] = depth1;
}

// S3: a cast lane whose shadow ray reached its light, or nothing, sees it.
__global__ void __launch_bounds__(kThreads) shade_s3_kernel(ShadeArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n || a.sh_alive[i] == 0) return;
  const int ltri = (int)a.light[kLTri * a.n + i];
  if (a.sh_hit[i] != 0 && a.sh_idx[i] != ltri) return;
  store3(a.rad_out, i, load3(a.rad_vis, i));
}

int launch(void (*kernel)(ShadeArgs), const ShadeArgs* a, void* stream) {
  if (a->n <= 0) return (int)cudaSuccess;
  const long long blocks = (a->n + kThreads - 1) / kThreads;
#ifdef __CUDACC__
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
#else
  // built for the host by the CPU tests (tests/shade_host/): the grid as a
  // loop, so that they can hold this arithmetic against the torch chain
  for (blockIdx.x = 0; blockIdx.x < blocks; ++blockIdx.x)
    for (threadIdx.x = 0; threadIdx.x < kThreads; ++threadIdx.x) kernel(*a);
  return (int)cudaSuccess;
#endif
}

}  // namespace

extern "C" int pbr_shade_s1(const ShadeArgs* a, void* stream) {
  return launch(shade_s1_kernel, a, stream);
}

extern "C" int pbr_shade_s2(const ShadeArgs* a, void* stream) {
  return launch(shade_s2_kernel, a, stream);
}

extern "C" int pbr_shade_s3(const ShadeArgs* a, void* stream) {
  return launch(shade_s3_kernel, a, stream);
}

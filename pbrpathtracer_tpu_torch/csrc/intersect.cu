// Dense closest-hit kernel for Hopper (sm_90a).
//
// Replaces pbrpathtracer_tpu/kernels/intersect_pallas.py::_kernel, launched
// by _run (the dense route of intersect_pallas, scenes of at most 4 chunks of
// 512 triangles). It computes the same function: per ray, the closest
// Möller–Trumbore hit over all triangles with t > EPS and t > t_lower; ties go
// to the lowest triangle row. The kernel writes the query's final outputs:
// hit as the bytes of a bool, the winner's id mapped through `perm` (the
// scene id of each row; null: the row itself), and a clean miss
// (hit 0, idx = t = u = v = 0) for misses and dead lanes. Nothing is left for
// the wrapper to do, so a query is one launch.
//
// What bounds it: at 24-588 triangles and 2^18 rays the work is pair tests,
// ~47 FP32 operations each, against 9 floats of triangle data that every ray
// reads, so the kernel is bound by FP32 issue, not by device memory (a ray
// reads 29 bytes and writes 17). The design answers that:
//   * one thread per ray; a block stages each chunk of <= 512 triangles
//     into shared memory once, as three float4 per triangle (24 KB), where
//     all its threads read the same triangle at the same time (a broadcast,
//     no bank conflicts, three 16-byte loads per pair test instead of nine);
//   * a block's rays come in as two coalesced runs of 3 x 128 floats through
//     shared memory, not as stride-3 reads per thread;
//   * before a chunk, each thread slab-tests the chunk's EPS-inflated box,
//     pruned by its running best t and by `alive`; __syncthreads_or skips the
//     staging and the pair tests when no ray of the block can hit the chunk.
// The tensor cores do not apply: a pair test must round after every product
// and sum as the plain version does, which no matrix instruction offers.
//
// Numerics: built with --fmad=false and without fast math, so every product
// and sum rounds on its own, in the order of intersect_pallas.py:174-196 and
// of the plain torch version (ops/intersect.py); 1/a is IEEE division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kEps = 1e-5f;
constexpr float kTiny = 1e-30f;
constexpr int kMaxChunk = 512;
constexpr int kThreads = 128;

// |rd| clamped to >= kTiny keeps the slab products finite or infinite, never
// 0 * inf = NaN, when a direction component is 0 and the origin lies on a
// slab plane (intersect_pallas.py:143-150).
__device__ __forceinline__ float safe_inv(float d) {
  if (fabsf(d) < kTiny) d = d < 0.0f ? -kTiny : kTiny;
  return 1.0f / d;
}

__global__ void __launch_bounds__(kThreads)
intersect_dense_kernel(const float* __restrict__ ro,
                       const float* __restrict__ rd,
                       const float* __restrict__ t_lower,
                       const uint8_t* __restrict__ alive,
                       const float* __restrict__ tris,
                       const float* __restrict__ boxes,
                       const int* __restrict__ perm,
                       int n, int n_tris, int chunk,
                       uint8_t* __restrict__ out_hit, int* __restrict__ out_i,
                       float* __restrict__ out_t, float* __restrict__ out_u,
                       float* __restrict__ out_v) {
  __shared__ float4 s_tri[kMaxChunk * 3];
  __shared__ float s_ro[kThreads * 3];
  __shared__ float s_rd[kThreads * 3];

  const int lane0 = blockIdx.x * kThreads;
  const int lane = lane0 + threadIdx.x;
  const int staged = 3 * min(kThreads, n - lane0);
  for (int k = threadIdx.x; k < staged; k += kThreads) {
    s_ro[k] = ro[(size_t)3 * lane0 + k];
    s_rd[k] = rd[(size_t)3 * lane0 + k];
  }
  __syncthreads();
  // null alive: every lane is live; null t_lower: no lower bound
  const bool live = lane < n && (alive == nullptr || alive[lane] != 0);
  float rdx = 1.0f, rdy = 1.0f, rdz = 1.0f;
  float rox = 0.0f, roy = 0.0f, roz = 0.0f, tl = 0.0f;
  if (live) {
    rdx = s_rd[3 * threadIdx.x + 0];
    rdy = s_rd[3 * threadIdx.x + 1];
    rdz = s_rd[3 * threadIdx.x + 2];
    rox = s_ro[3 * threadIdx.x + 0];
    roy = s_ro[3 * threadIdx.x + 1];
    roz = s_ro[3 * threadIdx.x + 2];
    if (t_lower != nullptr) tl = t_lower[lane];
  }
  const float irx = safe_inv(rdx), iry = safe_inv(rdy), irz = safe_inv(rdz);

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_i = 0;
  const int n_chunks = (n_tris + chunk - 1) / chunk;
  for (int c = 0; c < n_chunks; ++c) {
    // ---- chunk cull: slab test against the box, pruned by best t ----
    const float* box = boxes + 6 * c;
    const float t1x = (box[0] - rox) * irx, t2x = (box[3] - rox) * irx;
    const float t1y = (box[1] - roy) * iry, t2y = (box[4] - roy) * iry;
    const float t1z = (box[2] - roz) * irz, t2z = (box[5] - roz) * irz;
    const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                           fminf(t1z, t2z));
    const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                           fmaxf(t1z, t2z));
    const bool can_hit = live && tn < tf && tf > 0.0f && tn < best_t;
    // Also the barrier that keeps the previous chunk's readers ahead of
    // this chunk's staging.
    if (!__syncthreads_or(can_hit)) continue;

    const int base = c * chunk;
    const int rows = min(chunk, n_tris - base);
    // [rows, 9] rows (v0, e1, e2) into three padded float4 per triangle
    float* s_flat = reinterpret_cast<float*>(s_tri);
    for (int k = threadIdx.x; k < rows * 9; k += kThreads) {
      const int row = k / 9, col = k - 9 * row;
      s_flat[12 * row + 4 * (col / 3) + col % 3] = tris[(size_t)base * 9 + k];
    }
    __syncthreads();
    if (!can_hit) continue;

    for (int j = 0; j < rows; ++j) {
      const float4 p0 = s_tri[3 * j], p1 = s_tri[3 * j + 1],
                   p2 = s_tri[3 * j + 2];
      const float v0x = p0.x, v0y = p0.y, v0z = p0.z;
      const float e1x = p1.x, e1y = p1.y, e1z = p1.z;
      const float e2x = p2.x, e2y = p2.y, e2z = p2.z;
      const float hx = rdy * e2z - rdz * e2y;
      const float hy = rdz * e2x - rdx * e2z;
      const float hz = rdx * e2y - rdy * e2x;
      const float a = e1x * hx + e1y * hy + e1z * hz;
      const float sx = rox - v0x;
      const float sy = roy - v0y;
      const float sz = roz - v0z;
      const float u_num = sx * hx + sy * hy + sz * hz;
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v_num = rdx * qx + rdy * qy + rdz * qz;
      const float t_num = e2x * qx + e2y * qy + e2z * qz;
      const bool denom_ok = fabsf(a) >= kEps;
      const float f = denom_ok ? 1.0f / a : 0.0f;
      const float u = u_num * f;
      const float v = v_num * f;
      const float t = t_num * f;
      const bool valid = denom_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                         u + v <= 1.0f && t > kEps && t > tl;
      // strict <: the lowest row wins a tie, across chunks as within one
      if (valid && t < best_t) {
        best_t = t;
        best_u = u;
        best_v = v;
        best_i = base + j;
      }
    }
  }
  if (lane < n) {
    // best_u, best_v and best_i are still 0 on a miss
    const bool hit = best_t < kBig;
    out_hit[lane] = hit ? 1 : 0;
    out_i[lane] = hit && perm != nullptr ? perm[best_i] : best_i;
    out_t[lane] = hit ? best_t : 0.0f;
    out_u[lane] = best_u;
    out_v[lane] = best_v;
  }
}

}  // namespace

// t_lower, alive and perm may be null (no lower bound, every lane alive, ids
// are rows). out_hit is the storage of a bool tensor.
extern "C" int pbr_intersect_dense(const float* ro, const float* rd,
                                   const float* t_lower, const uint8_t* alive,
                                   const float* tris, const float* boxes,
                                   const int* perm, int n, int n_tris,
                                   int chunk, uint8_t* out_hit, int* out_i,
                                   float* out_t, float* out_u, float* out_v,
                                   void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  intersect_dense_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ro, rd, t_lower, alive, tris, boxes, perm, n, n_tris, chunk, out_hit,
      out_i, out_t, out_u, out_v);
  return (int)cudaGetLastError();
}

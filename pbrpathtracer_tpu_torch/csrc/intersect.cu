// Dense closest-hit kernel for Hopper (sm_90a).
//
// Replaces pbrpathtracer_tpu/kernels/intersect_pallas.py::_kernel, launched
// by _run (the dense route of intersect_pallas, scenes of at most 4 chunks of
// 512 triangles). It computes the same function: per ray, the closest
// Möller–Trumbore hit over all triangles with t > EPS and t > t_lower; ties go
// to the lowest triangle row; a miss or a dead lane keeps t = BIG, u = v = 0,
// id = 0 (the wrapper turns BIG into a clean miss).
//
// What bounds it: at 24-588 triangles and 2^18 rays the work is pair tests,
// ~40 FP32 operations each, against 9 floats of triangle data that every ray
// reads, so the kernel is bound by FP32 issue, not by device memory (a ray
// reads 32 bytes and writes 16). The design answers that:
//   * one thread per ray; a block stages each chunk of <= 512 triangles
//     (18 KB) into shared memory once, where all its threads read the same
//     triangle at the same time (a broadcast, no bank conflicts);
//   * before a chunk, each thread slab-tests the chunk's EPS-inflated box,
//     pruned by its running best t and by `alive`; __syncthreads_or skips the
//     staging and the pair tests when no ray of the block can hit the chunk.
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
                       int n, int n_tris, int chunk,
                       float* __restrict__ out_t, float* __restrict__ out_u,
                       float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float s_tri[kMaxChunk * 9];

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < n && alive[lane] != 0;
  float rdx = 1.0f, rdy = 1.0f, rdz = 1.0f;
  float rox = 0.0f, roy = 0.0f, roz = 0.0f, tl = 0.0f;
  if (live) {
    rdx = rd[3 * lane + 0];
    rdy = rd[3 * lane + 1];
    rdz = rd[3 * lane + 2];
    rox = ro[3 * lane + 0];
    roy = ro[3 * lane + 1];
    roz = ro[3 * lane + 2];
    tl = t_lower[lane];
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
    for (int k = threadIdx.x; k < rows * 9; k += blockDim.x)
      s_tri[k] = tris[base * 9 + k];
    __syncthreads();
    if (!can_hit) continue;

    for (int j = 0; j < rows; ++j) {
      const float* tri = s_tri + 9 * j;
      const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
      const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
      const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
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
    out_t[lane] = best_t;
    out_u[lane] = best_u;
    out_v[lane] = best_v;
    out_i[lane] = best_i;
  }
}

}  // namespace

extern "C" int pbr_intersect_dense(const float* ro, const float* rd,
                                   const float* t_lower, const uint8_t* alive,
                                   const float* tris, const float* boxes,
                                   int n, int n_tris, int chunk, float* out_t,
                                   float* out_u, float* out_v, int* out_i,
                                   void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  intersect_dense_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ro, rd, t_lower, alive, tris, boxes, n, n_tris, chunk, out_t, out_u,
      out_v, out_i);
  return (int)cudaGetLastError();
}

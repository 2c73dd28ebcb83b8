// BVH closest-hit kernel for Hopper (sm_90a): K4, the large-scene query.
//
// Replaces pbrpathtracer_tpu/kernels/intersect_pallas_list.py::_kernel,
// launched by run_list_kernel (the route intersect_pallas takes for scenes
// of more than 4 chunks of 512 triangles). It computes the same function:
// per ray, the closest Möller–Trumbore hit over all triangles with t > EPS
// and t > t_lower; exact-t ties go to the lowest position key `pos` of the
// triangle's slot (the slot itself when the scene has a BVH, the scene id
// when the wrapper built a private one), as the TPU kernel's (t, id)
// lexicographic winner does; a dead lane or a miss writes hit = 0 and
// id = t = u = v = 0, and a hit writes the slot's scene id perm[slot].
//
// What it computes, not how the TPU schedules it: the superchunk candidate
// lists, the 1024-aligned SMEM rows and the DMA semaphores exist to feed a
// sequential grid over ray tiles. Here each thread walks the BVH for its own
// ray, stackless over the escape links of the flat layout
// (accel/build.py): on a box hit go to node i + 1, on a miss to escape[i].
// Leaves hold consecutive slots of f32[T, 9] (v0, e1, e2) rows.
//
// What bounds it: scattered reads. A ray visits tens to hundreds of nodes
// (32 bytes of box and 16 of links each) and a few leaves (36 bytes a
// triangle), nearly all served by L2 at 50k triangles (a 1.8 MB tri table,
// 0.8 MB of nodes) and by device memory at 1M; the lanes of a warp diverge
// as their walks part. This first version keeps the plain DFS order (no
// near-child-first descent, no shared-memory treelets): simple and exact.
//
// Exactness: the walk prunes a box only when the ray misses it or enters it
// beyond the best t (tnear <= best_t keeps a box whose triangle could tie),
// and the wrapper inflates every box by EPS, so no triangle that could win
// is ever culled. Built with --fmad=false and without fast math, every
// product and sum rounds on its own in the order of intersect.cu and of the
// plain torch version (ops/intersect.py), so the winners are the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kEps = 1e-5f;
constexpr float kTiny = 1e-30f;
constexpr int kThreads = 128;
constexpr int kNoPos = 0x7fffffff;

// |rd| clamped to >= kTiny keeps the slab products finite or infinite, never
// 0 * inf = NaN, when a direction component is 0 and the origin lies on a
// slab plane (as intersect.cu).
__device__ __forceinline__ float safe_inv(float d) {
  if (fabsf(d) < kTiny) d = d < 0.0f ? -kTiny : kTiny;
  return 1.0f / d;
}

__global__ void __launch_bounds__(kThreads)
bvh_intersect_kernel(const float* __restrict__ ro,
                     const float* __restrict__ rd,
                     const float* __restrict__ t_lower,
                     const uint8_t* __restrict__ alive,
                     const float4* __restrict__ nodes,  // [M][2]: lo, hi
                     const int4* __restrict__ links,    // [M]: first, count, escape
                     const float* __restrict__ tris,    // [T][9]
                     const int* __restrict__ pos,       // [T]
                     const int* __restrict__ perm,      // [T]
                     int n, int n_nodes,
                     uint8_t* __restrict__ out_hit, int* __restrict__ out_i,
                     float* __restrict__ out_t, float* __restrict__ out_u,
                     float* __restrict__ out_v) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  if (alive[lane] == 0) {
    out_hit[lane] = 0;
    out_i[lane] = 0;
    out_t[lane] = 0.0f;
    out_u[lane] = 0.0f;
    out_v[lane] = 0.0f;
    return;
  }
  const size_t r = 3 * (size_t)lane;
  const float rdx = rd[r + 0], rdy = rd[r + 1], rdz = rd[r + 2];
  const float rox = ro[r + 0], roy = ro[r + 1], roz = ro[r + 2];
  const float tl = t_lower[lane];
  const float irx = safe_inv(rdx), iry = safe_inv(rdy), irz = safe_inv(rdz);

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_pos = kNoPos, best_slot = 0;
  int i = 0;
  while (i < n_nodes) {
    const float4 lo = __ldg(nodes + 2 * (size_t)i);
    const float4 hi = __ldg(nodes + 2 * (size_t)i + 1);
    const int4 link = __ldg(links + i);
    const float t1x = (lo.x - rox) * irx, t2x = (hi.x - rox) * irx;
    const float t1y = (lo.y - roy) * iry, t2y = (hi.y - roy) * iry;
    const float t1z = (lo.z - roz) * irz, t2z = (hi.z - roz) * irz;
    const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                           fminf(t1z, t2z));
    const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                           fmaxf(t1z, t2z));
    if (!(tn < tf && tf > 0.0f && tn <= best_t)) {
      i = link.z;  // skip the subtree
      continue;
    }
    for (int s = link.x; s < link.x + link.y; ++s) {  // leaf slots, if any
      const float* tri = tris + 9 * (size_t)s;
      const float v0x = __ldg(tri + 0), v0y = __ldg(tri + 1),
                  v0z = __ldg(tri + 2);
      const float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4),
                  e1z = __ldg(tri + 5);
      const float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7),
                  e2z = __ldg(tri + 8);
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
      if (valid && t <= best_t) {
        const int p = __ldg(pos + s);
        if (t < best_t || p < best_pos) {  // (t, position) lexicographic
          best_t = t;
          best_u = u;
          best_v = v;
          best_pos = p;
          best_slot = s;
        }
      }
    }
    ++i;  // into the children, or past a leaf (its escape is i + 1)
  }
  const bool hit = best_t < kBig;
  out_hit[lane] = hit ? 1 : 0;
  out_i[lane] = hit ? __ldg(perm + best_slot) : 0;
  out_t[lane] = hit ? best_t : 0.0f;
  out_u[lane] = hit ? best_u : 0.0f;
  out_v[lane] = hit ? best_v : 0.0f;
}

}  // namespace

extern "C" int pbr_intersect_bvh(const float* ro, const float* rd,
                                 const float* t_lower, const uint8_t* alive,
                                 const float* nodes, const int* links,
                                 const float* tris, const int* pos,
                                 const int* perm, int n, int n_nodes,
                                 uint8_t* out_hit, int* out_i, float* out_t,
                                 float* out_u, float* out_v, void* stream) {
  if (n_nodes < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  bvh_intersect_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ro, rd, t_lower, alive, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const int4*>(links), tris, pos, perm, n, n_nodes,
      out_hit, out_i, out_t, out_u, out_v);
  return (int)cudaGetLastError();
}

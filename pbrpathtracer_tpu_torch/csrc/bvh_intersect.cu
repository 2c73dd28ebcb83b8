// BVH closest-hit kernel for Hopper (sm_90a): K4, the large-scene query.
//
// Replaces pbrpathtracer_tpu/kernels/intersect_pallas_list.py::_kernel,
// launched by run_list_kernel (the route intersect_pallas takes for scenes
// of more than 4 chunks of 512 triangles). It computes the same function:
// per ray, the closest Möller–Trumbore hit over all triangles with t > EPS
// and t > t_lower; exact-t ties go to the lowest position key of the
// triangle's slot (the slot itself when the scene has a BVH, `pos[slot]`,
// the scene id, when the wrapper built a private one), as the TPU kernel's
// (t, id) lexicographic winner does; a dead lane or a miss writes hit = 0 and
// id = t = u = v = 0, and a hit writes the slot's scene id perm[slot].
//
// What it computes, not how the TPU schedules it: the superchunk candidate
// lists, the 1024-aligned SMEM rows and the DMA semaphores exist to feed a
// sequential grid over ray tiles. Here each thread walks a BVH for its own
// ray.
//
// What bounds it: latency, not bytes or FP32 throughput. Every step of a walk
// is a load whose address the step before decided, answered by L2 (the 50k
// scene's 0.5 MB of nodes and 2.4 MB of rows sit there, the 1M scene's 11 and
// 48 MB mostly), followed by a chain of dependent FP32 operations; a launch
// of 262,144 rays is a few residencies of the card and lasts little longer
// than its longest walks (on an NVIDIA H100 80GB HBM3 at 700 W, 16,384
// primary rays of the 1M scene take 0.086 ms and sixteen times as many
// 0.145 ms; chip_smoke.py times both). The design shortens the chains and
// puts more into each round trip:
//   * a 4-wide tree (kernels/intersect_list.py collapses the scene's binary
//     one): a node is one 128-byte aligned record, six float4 of child boxes
//     (lo.x[4], lo.y[4], lo.z[4], hi.x[4], hi.y[4], hi.z[4]) and one int4 of
//     children, all seven loads issued together, so one round trip brings
//     four boxes and a walk is half as deep;
//   * near child first: the children the ray enters no later than the best t
//     are ordered by their entry distance (a five-exchange sorting network
//     on registers), the nearest is walked next, the others wait on a
//     per-thread stack (local memory: kStack entries of 8 bytes, served by
//     L1; the wrapper refuses a tree deeper than kStack / 3 levels). A popped
//     entry is dropped when its entry distance lies beyond the best t of
//     that moment, so what lies behind the first hit is mostly never read:
//     a primary ray of the 50k scene reads 8.3 records in the mean;
//   * leaf rows as three float4 (v0, e1, e2, each padded to 16 bytes): the
//     rows of up to four triangles are loaded before the first is tested
//     (eight at once cost 50 registers and were slower, two or one traded
//     2% on coherent rays for 3-5% on incoherent ones);
//   * the lanes of a warp walk nodes until each stands at a leaf or has
//     finished, then test leaves: two loops inside one, so that a warp does
//     not pay both bodies on every step.
// A child is a wide node's index (>= 0) or a leaf, ~(first << 4 | count)
// (< 0; -1, a leaf of nothing, marks an empty slot).
// Tried on the card and dropped (PERF.md has the times): the top of the tree
// in shared memory, warp packets from an atomic counter, blocks of 64 and
// 256 threads, a register cap, a prefetch of the second-nearest child, one
// loop for both kinds of step, and an 8-wide tree with 8-bit quantized boxes
// (fewer round trips and bytes, more arithmetic per node: slower).
//
// Exactness: the winner is the minimum of (t, position) in lexicographic
// order over every triangle the ray hits, which does not depend on the order
// of visits. A box is dropped only when the ray misses it or enters it
// strictly beyond the best t (a box whose triangle could tie is kept), and
// the wrapper inflates every box by EPS, so no triangle that could win is
// culled. Built with --fmad=false and without fast math, every product and
// sum rounds on its own in the order of intersect.cu and of the plain torch
// version (ops/intersect.py), so the winners are the same bits.
//
// The counting instantiation (pbr_intersect_bvh_stats) is the same walk
// that also writes, per ray, the node records read and the triangles tested.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kEps = 1e-5f;
constexpr float kTiny = 1e-30f;
constexpr int kThreads = 128;
constexpr int kNoPos = 0x7fffffff;
constexpr int kStack = 64;
constexpr int kCountBits = 4;
constexpr int kEmpty = -1;
constexpr int kLeafGroup = 4;  // leaf rows loaded before the first is tested

// |rd| clamped to >= kTiny keeps the slab products finite or infinite, never
// 0 * inf = NaN, when a direction component is 0 and the origin lies on a
// slab plane (as intersect.cu).
__device__ __forceinline__ float safe_inv(float d) {
  if (fabsf(d) < kTiny) d = d < 0.0f ? -kTiny : kTiny;
  return 1.0f / d;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tl;
};

struct Best {
  float t, u, v;
  int pos, slot;
};

// The entry distance of a child box when the ray can still find a winner in
// it, +inf when not.
__device__ __forceinline__ float child_key(float lox, float loy, float loz,
                                           float hix, float hiy, float hiz,
                                           int child, const Ray& r,
                                           float best_t) {
  const float t1x = (lox - r.ox) * r.ix, t2x = (hix - r.ox) * r.ix;
  const float t1y = (loy - r.oy) * r.iy, t2y = (hiy - r.oy) * r.iy;
  const float t1z = (loz - r.oz) * r.iz, t2z = (hiz - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                         fminf(t1z, t2z));
  const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                         fmaxf(t1z, t2z));
  const bool enter = child != kEmpty && tn < tf && tf > 0.0f && tn <= best_t;
  return enter ? tn : __int_as_float(0x7f800000);
}

__device__ __forceinline__ void order(float& ka, int& ca, float& kb, int& cb) {
  if (kb < ka) {
    const float k = ka;
    ka = kb;
    kb = k;
    const int c = ca;
    ca = cb;
    cb = c;
  }
}

__device__ __forceinline__ void pair_test(const float4 p0, const float4 p1,
                                          const float4 p2, int slot,
                                          const int* __restrict__ pos,
                                          const Ray& r, Best& best) {
  const float v0x = p0.x, v0y = p0.y, v0z = p0.z;
  const float e1x = p1.x, e1y = p1.y, e1z = p1.z;
  const float e2x = p2.x, e2y = p2.y, e2z = p2.z;
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  const float u_num = sx * hx + sy * hy + sz * hz;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v_num = r.dx * qx + r.dy * qy + r.dz * qz;
  const float t_num = e2x * qx + e2y * qy + e2z * qz;
  const bool denom_ok = fabsf(a) >= kEps;
  const float f = denom_ok ? 1.0f / a : 0.0f;
  const float u = u_num * f;
  const float v = v_num * f;
  const float t = t_num * f;
  const bool valid = denom_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                     u + v <= 1.0f && t > kEps && t > r.tl;
  if (valid && t <= best.t) {
    const int p = pos != nullptr ? __ldg(pos + slot) : slot;
    if (t < best.t || p < best.pos) {  // (t, position) lexicographic
      best.t = t;
      best.u = u;
      best.v = v;
      best.pos = p;
      best.slot = slot;
    }
  }
}

template <bool kCount>
__device__ __forceinline__ void walk(const Ray& r,
                                     const float4* __restrict__ nodes,
                                     const float4* __restrict__ tris,
                                     const int* __restrict__ pos, Best& best,
                                     int& n_nodes, int& n_tris) {
  float stack_key[kStack];
  int stack_child[kStack];
  int sp = 0;
  int cur = 0;  // the root record
  const float inf = __int_as_float(0x7f800000);
  for (;;) {
    bool done = false;
    while (cur >= 0) {
      const float4* rec = nodes + 8 * (size_t)cur;
      const float4 lox = __ldg(rec + 0), loy = __ldg(rec + 1),
                   loz = __ldg(rec + 2);
      const float4 hix = __ldg(rec + 3), hiy = __ldg(rec + 4),
                   hiz = __ldg(rec + 5);
      const int4 ch = __ldg(reinterpret_cast<const int4*>(rec + 6));
      if (kCount) ++n_nodes;
      float k0 = child_key(lox.x, loy.x, loz.x, hix.x, hiy.x, hiz.x, ch.x, r,
                           best.t);
      float k1 = child_key(lox.y, loy.y, loz.y, hix.y, hiy.y, hiz.y, ch.y, r,
                           best.t);
      float k2 = child_key(lox.z, loy.z, loz.z, hix.z, hiy.z, hiz.z, ch.z, r,
                           best.t);
      float k3 = child_key(lox.w, loy.w, loz.w, hix.w, hiy.w, hiz.w, ch.w, r,
                           best.t);
      int c0 = ch.x, c1 = ch.y, c2 = ch.z, c3 = ch.w;
      order(k0, c0, k1, c1);
      order(k2, c2, k3, c3);
      order(k0, c0, k2, c2);
      order(k1, c1, k3, c3);
      order(k1, c1, k2, c2);
      if (k0 < inf) {
        // the farthest first, so that the nearest of them is popped first
        if (k3 < inf) {
          stack_key[sp] = k3;
          stack_child[sp++] = c3;
        }
        if (k2 < inf) {
          stack_key[sp] = k2;
          stack_child[sp++] = c2;
        }
        if (k1 < inf) {
          stack_key[sp] = k1;
          stack_child[sp++] = c1;
        }
        cur = c0;
        continue;
      }
      // nothing entered: back to the nearest entry that can still win
      done = true;
      while (sp > 0) {
        --sp;
        if (stack_key[sp] <= best.t) {
          cur = stack_child[sp];
          done = false;
          break;
        }
      }
      if (done) break;
    }
    if (done) break;

    // a leaf: `count` consecutive slots from `first`
    const int code = ~cur;
    const int first = code >> kCountBits;
    const int count = code & ((1 << kCountBits) - 1);
    if (kCount) n_tris += count;
    for (int base = 0; base < count; base += kLeafGroup) {
      float4 p0[kLeafGroup], p1[kLeafGroup], p2[kLeafGroup];
#pragma unroll
      for (int j = 0; j < kLeafGroup; ++j) {
        if (base + j < count) {
          const float4* row = tris + 3 * (size_t)(first + base + j);
          p0[j] = __ldg(row + 0);
          p1[j] = __ldg(row + 1);
          p2[j] = __ldg(row + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < kLeafGroup; ++j) {
        if (base + j < count) {
          pair_test(p0[j], p1[j], p2[j], first + base + j, pos, r, best);
        }
      }
    }

    done = true;
    while (sp > 0) {
      --sp;
      if (stack_key[sp] <= best.t) {
        cur = stack_child[sp];
        done = false;
        break;
      }
    }
    if (done) break;
  }
}

template <bool kCount>
__device__ __forceinline__ void trace_lane(
    int lane, const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t_lower, const uint8_t* __restrict__ alive,
    const float4* __restrict__ nodes, const float4* __restrict__ tris,
    const int* __restrict__ pos,
    const int* __restrict__ perm, uint8_t* __restrict__ out_hit,
    int* __restrict__ out_i, float* __restrict__ out_t,
    float* __restrict__ out_u, float* __restrict__ out_v,
    int* __restrict__ out_nodes, int* __restrict__ out_tris) {
  Best best = {kBig, 0.0f, 0.0f, kNoPos, 0};
  int read = 0, tested = 0;
  if (alive[lane] != 0) {
    const size_t k = 3 * (size_t)lane;
    Ray r;
    r.dx = rd[k + 0];
    r.dy = rd[k + 1];
    r.dz = rd[k + 2];
    r.ox = ro[k + 0];
    r.oy = ro[k + 1];
    r.oz = ro[k + 2];
    r.tl = t_lower[lane];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    walk<kCount>(r, nodes, tris, pos, best, read, tested);
  }
  const bool hit = best.t < kBig;
  out_hit[lane] = hit ? 1 : 0;
  out_i[lane] = hit ? __ldg(perm + best.slot) : 0;
  out_t[lane] = hit ? best.t : 0.0f;
  out_u[lane] = hit ? best.u : 0.0f;
  out_v[lane] = hit ? best.v : 0.0f;
  if (kCount) {
    out_nodes[lane] = read;
    out_tris[lane] = tested;
  }
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
bvh_intersect_kernel(const float* __restrict__ ro,
                     const float* __restrict__ rd,
                     const float* __restrict__ t_lower,
                     const uint8_t* __restrict__ alive,
                     const float4* __restrict__ nodes,  // [M][8]
                     const float4* __restrict__ tris,   // [T][3]
                     const int* __restrict__ pos,       // [T] or null
                     const int* __restrict__ perm,      // [T]
                     int n, int n_nodes,
                     uint8_t* __restrict__ out_hit, int* __restrict__ out_i,
                     float* __restrict__ out_t, float* __restrict__ out_u,
                     float* __restrict__ out_v, int* __restrict__ out_nodes,
                     int* __restrict__ out_tris) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) {
    trace_lane<kCount>(lane, ro, rd, t_lower, alive, nodes, tris, pos, perm,
                       out_hit, out_i, out_t, out_u, out_v, out_nodes,
                       out_tris);
  }
}

template <bool kCount>
int launch(const float* ro, const float* rd, const float* t_lower,
           const uint8_t* alive, const float* nodes, const float* tris,
           const int* pos, const int* perm, int n, int n_nodes,
           uint8_t* out_hit, int* out_i, float* out_t, float* out_u,
           float* out_v, int* out_nodes, int* out_tris, void* stream) {
  if (n_nodes < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  bvh_intersect_kernel<kCount><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ro, rd, t_lower, alive, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), pos, perm, n, n_nodes, out_hit,
      out_i, out_t, out_u, out_v, out_nodes, out_tris);
  return (int)cudaGetLastError();
}

}  // namespace

// pos may be null: the position key of a slot is the slot itself.
extern "C" int pbr_intersect_bvh(const float* ro, const float* rd,
                                 const float* t_lower, const uint8_t* alive,
                                 const float* nodes, const float* tris,
                                 const int* pos, const int* perm, int n,
                                 int n_nodes, uint8_t* out_hit, int* out_i,
                                 float* out_t, float* out_u, float* out_v,
                                 void* stream) {
  return launch<false>(ro, rd, t_lower, alive, nodes, tris, pos, perm, n,
                       n_nodes, out_hit, out_i, out_t, out_u, out_v,
                       nullptr, nullptr, stream);
}

// The counting twin: the same outputs, and per ray the node records read and
// the triangles tested.
extern "C" int pbr_intersect_bvh_stats(
    const float* ro, const float* rd, const float* t_lower,
    const uint8_t* alive, const float* nodes, const float* tris,
    const int* pos, const int* perm, int n, int n_nodes, uint8_t* out_hit,
    int* out_i, float* out_t, float* out_u, float* out_v, int* out_nodes,
    int* out_tris, void* stream) {
  return launch<true>(ro, rd, t_lower, alive, nodes, tris, pos, perm, n,
                      n_nodes, out_hit, out_i, out_t, out_u, out_v,
                      out_nodes, out_tris, stream);
}

// Native BVH builder — binned-SAH construction emitting the same
// escape-linked flat layout as accel/build.py (bounds, first, count,
// escape, perm). Replaces the reference's random-axis median-sort builder
// (mesh.cpp:169-211) with a production-quality deterministic SAH build;
// invoked from Python via ctypes (accel/native.py) for large scenes where
// the pure-numpy builder is too slow (SURVEY.md §7 step 2).
//
// C ABI:
//   int ptx_build_bvh(const float* v0, const float* v1, const float* v2,
//                     int n_tris, int leaf_size,
//                     float* bounds_min, float* bounds_max,
//                     int* first, int* count, int* escape, int* perm,
//                     int max_nodes);
// Returns the node count, or -1 on overflow / bad input. Arrays are
// row-major [n,3] float32 / int32, caller-allocated (max_nodes rows).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Box &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Builder {
  const float *v0, *v1, *v2;
  int n_tris, leaf_size, max_nodes;
  float *bmin_out, *bmax_out;
  int *first_out, *count_out, *escape_out, *perm_out;

  std::vector<Box> tri_box;
  std::vector<Vec3> tri_centroid;
  std::vector<int> ids;
  int node_cursor = 0;
  int perm_cursor = 0;
  bool overflow = false;

  static constexpr int kBins = 16;

  Vec3 tri_vert(const float *arr, int i) const {
    return {arr[3 * i], arr[3 * i + 1], arr[3 * i + 2]};
  }

  int emit_node(const Box &b) {
    if (node_cursor >= max_nodes) {
      overflow = true;
      return -1;
    }
    int n = node_cursor++;
    // degenerate-extent epsilon (AABB::Check parity, mesh.cpp:32-46)
    bmin_out[3 * n] = b.lo.x;
    bmin_out[3 * n + 1] = b.lo.y;
    bmin_out[3 * n + 2] = b.lo.z;
    bmax_out[3 * n] = std::max(b.hi.x, b.lo.x + 1e-5f);
    bmax_out[3 * n + 1] = std::max(b.hi.y, b.lo.y + 1e-5f);
    bmax_out[3 * n + 2] = std::max(b.hi.z, b.lo.z + 1e-5f);
    first_out[n] = 0;
    count_out[n] = 0;
    escape_out[n] = 0;
    return n;
  }

  void build(int begin, int end) {
    Box bounds;
    for (int i = begin; i < end; ++i) bounds.grow(tri_box[ids[i]]);
    int node = emit_node(bounds);
    if (node < 0) return;
    int n = end - begin;

    bool make_leaf = n <= leaf_size;
    int split = -1, axis = -1;

    if (!make_leaf) {
      // binned SAH over the centroid bounds
      Box cb;
      for (int i = begin; i < end; ++i) cb.grow(tri_centroid[ids[i]]);
      float best_cost = FLT_MAX;
      float leaf_cost = (float)n;
      for (int ax = 0; ax < 3; ++ax) {
        float lo = ax == 0 ? cb.lo.x : (ax == 1 ? cb.lo.y : cb.lo.z);
        float hi = ax == 0 ? cb.hi.x : (ax == 1 ? cb.hi.y : cb.hi.z);
        float extent = hi - lo;
        if (extent <= 1e-12f) continue;
        Box bin_box[kBins];
        int bin_cnt[kBins] = {0};
        float inv = kBins / extent;
        for (int i = begin; i < end; ++i) {
          const Vec3 &c = tri_centroid[ids[i]];
          float cc = ax == 0 ? c.x : (ax == 1 ? c.y : c.z);
          int b = std::min(kBins - 1, std::max(0, (int)((cc - lo) * inv)));
          bin_box[b].grow(tri_box[ids[i]]);
          bin_cnt[b]++;
        }
        // sweep
        Box right[kBins];
        Box acc;
        int rc[kBins];
        int c = 0;
        for (int b = kBins - 1; b > 0; --b) {
          acc.grow(bin_box[b]);
          c += bin_cnt[b];
          right[b] = acc;
          rc[b] = c;
        }
        Box lacc;
        int lc = 0;
        for (int b = 0; b < kBins - 1; ++b) {
          lacc.grow(bin_box[b]);
          lc += bin_cnt[b];
          if (lc == 0 || rc[b + 1] == 0) continue;
          float cost =
              1.f + (lacc.area() * lc + right[b + 1].area() * rc[b + 1]) /
                        std::max(bounds.area(), 1e-12f);
          if (cost < best_cost) {
            best_cost = cost;
            axis = ax;
            split = b + 1;
          }
        }
      }
      if (axis < 0) {
        // SAH failed (all centroids coincide): median on largest box axis
        make_leaf = false;
        axis = 0;
        Vec3 e = {bounds.hi.x - bounds.lo.x, bounds.hi.y - bounds.lo.y,
                  bounds.hi.z - bounds.lo.z};
        if (e.y > e.x) axis = 1;
        if (e.z > (axis == 0 ? e.x : e.y)) axis = 2;
        int mid = begin + n / 2;
        std::nth_element(ids.begin() + begin, ids.begin() + mid,
                         ids.begin() + end, [&](int a, int b) {
                           const Vec3 &ca = tri_centroid[a];
                           const Vec3 &cbv = tri_centroid[b];
                           float fa = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                           float fb = axis == 0 ? cbv.x : (axis == 1 ? cbv.y : cbv.z);
                           return fa < fb;
                         });
        build(begin, mid);
        build(mid, end);
        escape_out[node] = node_cursor;
        return;
      }
      // partition by chosen bin
      Box cb2;
      for (int i = begin; i < end; ++i) cb2.grow(tri_centroid[ids[i]]);
      float lo = axis == 0 ? cb2.lo.x : (axis == 1 ? cb2.lo.y : cb2.lo.z);
      float hi = axis == 0 ? cb2.hi.x : (axis == 1 ? cb2.hi.y : cb2.hi.z);
      float inv = kBins / std::max(hi - lo, 1e-12f);
      auto side = [&](int id) {
        const Vec3 &c = tri_centroid[id];
        float cc = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = std::min(kBins - 1, std::max(0, (int)((cc - lo) * inv)));
        return b < split;
      };
      int *lo_it = ids.data() + begin;
      int *hi_it = ids.data() + end;
      int *mid_it = std::partition(lo_it, hi_it, side);
      int mid = (int)(mid_it - ids.data());
      if (mid == begin || mid == end) mid = begin + n / 2;  // safety
      build(begin, mid);
      build(mid, end);
      escape_out[node] = node_cursor;
      return;
    }

    // leaf
    first_out[node] = perm_cursor;
    count_out[node] = n;
    for (int i = begin; i < end; ++i) perm_out[perm_cursor++] = ids[i];
    escape_out[node] = node_cursor;
  }

  int run() {
    tri_box.resize(n_tris);
    tri_centroid.resize(n_tris);
    ids.resize(n_tris);
    for (int i = 0; i < n_tris; ++i) {
      Box b;
      b.grow(tri_vert(v0, i));
      b.grow(tri_vert(v1, i));
      b.grow(tri_vert(v2, i));
      tri_box[i] = b;
      tri_centroid[i] = {(b.lo.x + b.hi.x) * 0.5f, (b.lo.y + b.hi.y) * 0.5f,
                         (b.lo.z + b.hi.z) * 0.5f};
      ids[i] = i;
    }
    build(0, n_tris);
    return overflow ? -1 : node_cursor;
  }
};

}  // namespace

extern "C" int ptx_build_bvh(const float *v0, const float *v1,
                             const float *v2, int n_tris, int leaf_size,
                             float *bounds_min, float *bounds_max, int *first,
                             int *count, int *escape, int *perm,
                             int max_nodes) {
  if (n_tris <= 0 || leaf_size <= 0) return -1;
  Builder b;
  b.v0 = v0;
  b.v1 = v1;
  b.v2 = v2;
  b.n_tris = n_tris;
  b.leaf_size = leaf_size;
  b.max_nodes = max_nodes;
  b.bmin_out = bounds_min;
  b.bmax_out = bounds_max;
  b.first_out = first;
  b.count_out = count;
  b.escape_out = escape;
  b.perm_out = perm;
  return b.run();
}

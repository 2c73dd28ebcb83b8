// Pack-gather forward kernel for Hopper (sm_90a).
//
// Replaces pbrpathtracer_tpu/kernels/packgather_pallas.py::_fwd_kernel,
// launched by _run_fwd through gather_rows_t: out[w, n] = table[idx[n], w] for
// 0 <= idx[n] < T, else 0, into a field-major f32[W, N] block. The shading
// path fetches every per-lane triangle, material and light attribute through
// it, one wide row per lane.
//
// What bounds it: a pure copy, ~4 W bytes written per lane against a table of
// a few KB, so device-memory write bandwidth. The TPU kernel built a [T, TILE]
// one-hot in VMEM and ran a matmul (capped at T <= 256); here:
//   * one thread per lane n, looping over w, so a warp writes 32 consecutive
//     floats of each output row (coalesced);
//   * the whole table is staged in shared memory when it fits the default
//     48 KB (the Cornell tri pack is 36 x 55 x 4 = 7.9 KB), else its rows are
//     read through L1/L2 (the 588-row spheres pack, 129 KB). Any T works.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxStagedBytes = 48 * 1024;

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
packgather_fwd_kernel(const int* __restrict__ idx,
                      const float* __restrict__ table, int n, int n_rows,
                      int width, float* __restrict__ out) {
  extern __shared__ float s_table[];
  const float* tab = table;
  if (kStage) {
    for (int k = threadIdx.x; k < n_rows * width; k += blockDim.x)
      s_table[k] = table[k];
    __syncthreads();
    tab = s_table;
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int id = idx[lane];
  const bool ok = id >= 0 && id < n_rows;
  const float* row = tab + (size_t)(ok ? id : 0) * width;
  for (int w = 0; w < width; ++w)
    out[(size_t)w * n + lane] = ok ? row[w] : 0.0f;
}

}  // namespace

extern "C" int pbr_packgather_fwd(const int* idx, const float* table, int n,
                                  int n_rows, int width, float* out,
                                  void* stream) {
  if (n == 0 || width == 0) return (int)cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t bytes = (size_t)n_rows * width * sizeof(float);
  if (bytes <= kMaxStagedBytes) {
    packgather_fwd_kernel<true><<<blocks, kThreads, bytes,
                                  (cudaStream_t)stream>>>(idx, table, n,
                                                          n_rows, width, out);
  } else {
    packgather_fwd_kernel<false><<<blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(idx, table, n,
                                                           n_rows, width, out);
  }
  return (int)cudaGetLastError();
}

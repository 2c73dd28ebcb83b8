// Pack-gather kernels for Hopper (sm_90a): the forward (K2) and its backward
// (K3).
//
// Forward. Replaces pbrpathtracer_tpu/kernels/packgather_pallas.py::
// _fwd_kernel, launched by _run_fwd through gather_rows_t: out[w, n] =
// table[idx[n], w] for 0 <= idx[n] < T, else 0, into a field-major f32[W, N]
// block. The shading path fetches every per-lane triangle, material and
// light attribute through it, one wide row per lane.
//
// What bounds it: a pure copy, ~4 W bytes written per lane against a table of
// a few KB, so device-memory write bandwidth. The TPU kernel built a [T, TILE]
// one-hot in VMEM and ran a matmul (capped at T <= 256); here:
//   * one thread per lane n, looping over w, so a warp writes 32 consecutive
//     floats of each output row (coalesced);
//   * the whole table is staged in shared memory when it fits the default
//     48 KB (the Cornell tri pack is 36 x 55 x 4 = 7.9 KB), else its rows are
//     read through L1/L2 (the 588-row spheres pack, 129 KB). Any T works.
//
// Backward. Replaces packgather_pallas.py::_bwd_kernel, launched by _run_bwd
// through _gather_bwd: d_table[t, w] = sum of cot[w, n] over the lanes n with
// idx[n] == t; ids outside [0, T) are dropped. The TPU kernel carried one
// accumulator across its sequential grid; blocks here run in parallel and in
// no order, and float atomics would make the sum depend on that order (a fit
// must resume bit for bit), and would serialize on the few rows of a small
// table (262,144 lanes into Cornell's 36). So the reduction is two passes in
// a fixed order, with no atomics:
//   1. block (b, r) owns lanes [b L, (b+1) L) and the table rows
//      [r R, (r+1) R). Thread w owns column w: it walks the block's lanes in
//      order and adds cot[w, n] into a shared-memory accumulator row idx[n]
//      (only thread w ever touches column w, so there are no races, and
//      neighbouring threads hit neighbouring banks). R is chosen so that the
//      R x W accumulator fits 48 KB; taller tables (the spheres pack) take
//      several row tiles. The block writes its partial table to device
//      memory.
//   2. one thread per (t, w) sums the partial tables in block order.
// The sums run in double, so the result is the f32 rounding of a nearly
// exact sum whatever the lane count (thousands of lanes per row at 512^2);
// the same inputs give the same bits on every call. What bounds it: the
// per-column walk is latency-bound (one shared-memory read-modify-write per
// lane and column), and the partial tables cost ~T W 8 bytes per lane block.

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

// Pass 1: grid (lane blocks, row tiles); partial is f64[lane blocks, T, W].
__global__ void __launch_bounds__(kThreads)
packgather_bwd_partial_kernel(const int* __restrict__ idx,
                              const float* __restrict__ cot, int n,
                              int n_rows, int width, int lanes_per_block,
                              int rows_per_tile,
                              double* __restrict__ partial) {
  extern __shared__ double s_acc[];
  const int row0 = blockIdx.y * rows_per_tile;
  const int rows = min(rows_per_tile, n_rows - row0);
  for (int k = threadIdx.x; k < rows * width; k += blockDim.x)
    s_acc[k] = 0.0;
  __syncthreads();
  const int lane0 = blockIdx.x * lanes_per_block;
  const int lane1 = min(lane0 + lanes_per_block, n);
  for (int w = threadIdx.x; w < width; w += blockDim.x) {
    const float* col = cot + (size_t)w * n;
    for (int lane = lane0; lane < lane1; ++lane) {
      const int r = idx[lane] - row0;
      if (r >= 0 && r < rows) s_acc[r * width + w] += (double)col[lane];
    }
  }
  __syncthreads();
  double* dst = partial + ((size_t)blockIdx.x * n_rows + row0) * width;
  for (int k = threadIdx.x; k < rows * width; k += blockDim.x)
    dst[k] = s_acc[k];
}

// Pass 2: out[k] = sum over lane blocks b, in order, of partial[b, k].
__global__ void __launch_bounds__(kThreads)
packgather_bwd_sum_kernel(const double* __restrict__ partial, int n_blocks,
                          int size, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= size) return;
  double s = 0.0;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * size + k];
  out[k] = (float)s;
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

// cot is f32[W, N], out f32[T, W]; partial is caller-allocated scratch of
// n_blocks * T * W doubles with n_blocks = ceil(n / lanes_per_block).
extern "C" int pbr_packgather_bwd(const int* idx, const float* cot, int n,
                                  int n_rows, int width, int lanes_per_block,
                                  double* partial, float* out, void* stream) {
  if (n_rows == 0 || width == 0) return (int)cudaSuccess;
  // the accumulator must hold at least one row
  if (lanes_per_block < 1 || (size_t)width * sizeof(double) > kMaxStagedBytes)
    return (int)cudaErrorInvalidValue;
  const int size = n_rows * width;
  const int sum_blocks = (size + kThreads - 1) / kThreads;
  const int n_blocks = n == 0 ? 0 : (n + lanes_per_block - 1) / lanes_per_block;
  if (n_blocks > 0) {
    const int rows = (int)(kMaxStagedBytes / (sizeof(double) * width));
    const int tiles = (n_rows + rows - 1) / rows;
    const int threads = width >= kThreads ? kThreads : (width + 31) / 32 * 32;
    const size_t bytes = (size_t)(rows < n_rows ? rows : n_rows) * width
                         * sizeof(double);
    packgather_bwd_partial_kernel<<<dim3(n_blocks, tiles), threads, bytes,
                                    (cudaStream_t)stream>>>(
        idx, cot, n, n_rows, width, lanes_per_block, rows, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  packgather_bwd_sum_kernel<<<sum_blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(partial, n_blocks, size,
                                                      out);
  return (int)cudaGetLastError();
}

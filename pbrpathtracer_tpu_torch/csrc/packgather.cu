// Pack-gather kernels for Hopper (sm_90a): the forward (K2) and its backward
// (K3).
//
// Forward. Replaces pbrpathtracer_tpu/kernels/packgather_pallas.py::
// _fwd_kernel, launched by _run_fwd through gather_rows_t: out[w, n] =
// table[idx[n], w] for 0 <= idx[n] < T, else 0, into a field-major f32[W, N]
// block. The shading path fetches every per-lane triangle, material and
// light attribute through it, one wide row per lane: W = 55 (tri pack), 13
// (light pack), 9 (the winner rows of hit_vjp="winner"), 7 (uv-opacity), on
// tables of 2 rows up to a million.
//
// What bounds it: bytes. 4 N of ids, 4 W of table per distinct row the ids
// name, 4 W N of output: the output dominates (57.7 MB at N = 262,144 and
// W = 55 against 0.9 MB of rows that 512^2 primary hit ids name), so it is
// device-memory write bandwidth wherever the rows are read once. The TPU
// kernel built a [T, TILE] one-hot in VMEM and ran a matmul (capped at
// T <= 256). Here the launcher picks one of two paths by the table's size
// alone, and within the first its copy and store widths by alignment
// (never by a failed launch; a refused launch returns its error):
//   * a table of up to 226 KB with one zero row appended (the Cornell and
//     spheres tri packs, every light pack, W = 9 tables up to 6,427 rows, uv
//     packs up to 8,263) is staged in shared memory once per block: one TMA
//     bulk copy (cp.async.bulk, completing on an mbarrier) of its
//     16-byte-aligned part, the tail and the zero row by plain stores, while
//     the first ids load. Blocks are persistent (the grid is the SM count
//     times the occupancy that this staging allows) and walk groups of
//     lanes, the next group's ids in flight; an id out of range reads the
//     zero row. Where N % 4 == 0 and the ids and output are 16-byte aligned
//     a thread takes 4 consecutive lanes: one int4 of ids, and per column 4
//     shared loads and one 16-byte store, so a warp writes 512 contiguous
//     bytes of each output row; else one lane and 4-byte stores;
//   * a larger table (the 50k and 1M packs) is read in place, one thread per
//     lane looping over the columns: a warp's load of a column touches the
//     rows of its 32 lanes, whose sectors L1 keeps for the next columns, and
//     each of its stores writes 128 contiguous bytes. On the ids the renders
//     give (primary and bounce hit ids, whose misses all name row 0) this
//     first design stays: a warp-cooperative fetch of whole rows into
//     double-buffered shared tiles (cp.async, one instruction per 32
//     consecutive floats of the rows laid end to end) measured slower on
//     the H100 (PERF.md).
// A pure copy: both paths are bit-equal to gather_rows_t_plain.
//
// Backward. Replaces packgather_pallas.py::_bwd_kernel, launched by _run_bwd
// through _gather_bwd: d_table[t, w] = sum of cot[w, n] over the lanes n with
// idx[n] == t; ids outside [0, T) are dropped. The TPU kernel carried one
// accumulator across its sequential grid; blocks here run in parallel and in
// no order, and float atomics would make the sum depend on that order (a fit
// must resume bit for bit) and would serialize on the few rows of a small
// table (262,144 lanes into Cornell's 36). A table may have 2 rows or a
// million, and a row may own 2 lanes or half of them (row 0 collects every
// miss), so the work must not grow with T and no row may belong to one
// thread. The reduction therefore groups the lanes by id first and then
// reduces the groups, with no atomics on floats and every sum in a fixed
// order:
//   1. zero the output (rows that no lane touches stay zero);
//   2. order the lanes by id, stably: an LSD radix sort of (key, lane) with
//      8-bit digits, key = id or T for a dropped id, ceil(bits(T) / 8)
//      passes. A pass is three launches: per-block digit histograms (one
//      integer shared-memory atomic per distinct digit of a warp: counts do
//      not depend on order); a scan, one block per digit over that digit's
//      row of the digit-major [256, blocks] counts; and a scatter that ranks
//      the keys of a block in lane order (rounds of 256 keys;
//      __match_any_sync ranks a warp's equal digits, a per-digit walk over
//      the 8 warps ranks the warps), so equal ids keep their lane order;
//   3. reduce by key over chunks of 512 sorted lanes, one block each: a warp
//      takes 32 consecutive sorted lanes of one column (consecutive lanes of
//      cot[w, .] wherever the ids are coherent, as primary hits are), with
//      the next 32 already loading. Where the 32 lie inside one run (the
//      sky row, every row of a small table) each lane adds into its own
//      double and nothing is shuffled; where a run begins or ends the warp
//      folds those doubles into a carry and runs a segmented inclusive scan
//      in double by shuffles. Every run that ends in the chunk goes straight
//      to its row, except a first run that began in an earlier chunk, which
//      goes to the chunk's record A; the partial of a last run that goes on
//      into the next chunk goes to record B. 8 warps x 4 columns are in
//      flight per block;
//   4. fix up the rows that span chunks: one block per record A finds the
//      chunk where its run began (a binary search of the sorted keys) and,
//      eight threads per column, adds the B records of the chunks the run
//      came through, in a fixed order, then its A record.
// The sums run in double, so the result is the f32 rounding of a nearly
// exact sum whatever the lane count (thousands of lanes per row at 512^2);
// the order of every sum follows from the ids alone, so the same inputs give
// the same bits on every call. Scratch is 16 N bytes of keys and lanes, N / 8
// histogram integers and N W / 32 bytes of records: nothing grows with T.
// What bounds it: the bytes of the cotangent, read once (coalesced for
// coherent ids, by 32-byte sectors for random ones), plus the passes over the
// 8 N bytes of (key, lane) pairs; at 262,144 lanes the 3 + 3 per pass
// launches are a fixed cost of the same order as the reduction.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;        // the in-place forward; K3's zeroing

// ---- forward (K2) ---------------------------------------------------------

constexpr int kStageThreads = 512;
// The largest staged table, its zero row included: the H100's 227 KB of
// opt-in shared memory a block, less 1 KB for the barrier and alignment.
// kernels/packgather.py's FWD_STAGE_BYTES is this number.
constexpr size_t kStageMaxBytes = 226 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The table row of an id: itself, or `outside` for an id outside [0, T).
__device__ __forceinline__ int row_of(int id, int n_rows, int outside) {
  return (unsigned)id < (unsigned)n_rows ? id : outside;
}

// Small tables, staged. kVec lanes per thread and step: 4 (one int4 of ids,
// one float4 store per column) or 1. Row n_rows of s_table is zeros; an id
// outside [0, T) reads it. bulk_bytes (a multiple of 16, 0 for a table whose
// base is not 16-byte aligned) go by one TMA bulk copy, the rest by plain
// loads.
template <int kVec>
__global__ void __launch_bounds__(kStageThreads)
fwd_staged_kernel(const int* __restrict__ idx, const float* __restrict__ table,
                  int n, int n_rows, int width, int bulk_bytes,
                  float* __restrict__ out) {
  extern __shared__ __align__(128) float s_table[];
  __shared__ __align__(8) uint64_t s_bar;
  const uint32_t bar = smem_addr(&s_bar);
  if (bulk_bytes > 0) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
                   "r"(1)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(bulk_bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(s_table)),
          "l"(table), "r"(bulk_bytes), "r"(bar)
          : "memory");
    }
  }
  const int size = n_rows * width;
  for (int k = bulk_bytes / 4 + threadIdx.x; k < size + width;
       k += blockDim.x)
    s_table[k] = k < size ? table[k] : 0.0f;

  // the first step's ids load while the table arrives
  const int groups = n / kVec;
  const int step = gridDim.x * blockDim.x;
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  int4 ids4 = make_int4(0, 0, 0, 0);
  int ids1 = 0;
  if (g < groups) {
    if constexpr (kVec == 4)
      ids4 = reinterpret_cast<const int4*>(idx)[g];
    else
      ids1 = idx[g];
  }
  if (bulk_bytes > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(bar), "r"(0)
          : "memory");
    }
  }
  __syncthreads();

  for (; g < groups; g += step) {
    if constexpr (kVec == 4) {
      const int4 id = ids4;
      if (g + step < groups) ids4 = reinterpret_cast<const int4*>(idx)[g + step];
      const float* r0 = s_table + row_of(id.x, n_rows, n_rows) * width;
      const float* r1 = s_table + row_of(id.y, n_rows, n_rows) * width;
      const float* r2 = s_table + row_of(id.z, n_rows, n_rows) * width;
      const float* r3 = s_table + row_of(id.w, n_rows, n_rows) * width;
      float4* dst = reinterpret_cast<float4*>(out) + g;
      const size_t cols = (size_t)groups;  // float4s per output row
#pragma unroll 4
      for (int w = 0; w < width; ++w)
        dst[w * cols] = make_float4(r0[w], r1[w], r2[w], r3[w]);
    } else {
      const int id = ids1;
      if (g + step < groups) ids1 = idx[g + step];
      const float* r = s_table + row_of(id, n_rows, n_rows) * width;
      float* dst = out + g;
#pragma unroll 4
      for (int w = 0; w < width; ++w) dst[(size_t)w * n] = r[w];
    }
  }
}

// Larger tables, in place: a thread per lane.
__global__ void __launch_bounds__(kThreads)
fwd_in_place_kernel(const int* __restrict__ idx,
                    const float* __restrict__ table, int n, int n_rows,
                    int width, float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int row = row_of(idx[lane], n_rows, -1);
  const float* src = table + (size_t)(row < 0 ? 0 : row) * width;
  for (int w = 0; w < width; ++w)
    out[(size_t)w * n + lane] = row >= 0 ? src[w] : 0.0f;
}

// The staged kernels' grid. Per device: the SM count, and the kernels'
// shared-memory attributes set once. Per (kernel, device, shared bytes):
// blocks a SM can hold. Both are looked up under a lock, so that a launch
// costs no runtime query after the first of its kind.
constexpr int kMaxDevices = 64;
constexpr int kOccSlots = 32;
struct FwdDevice {
  bool ready;
  int sms;
  int smem_optin;
};
struct FwdOcc {
  const void* fn;
  int device;
  size_t smem;
  int per_sm;
};
std::mutex g_fwd_mutex;
FwdDevice g_fwd_device[kMaxDevices];
FwdOcc g_fwd_occ[kOccSlots];
int g_fwd_occ_next = 0;

cudaError_t staged_blocks(const void* fn, size_t smem, int groups,
                          int* blocks) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_fwd_mutex);
  FwdDevice& d = g_fwd_device[device];
  if (!d.ready) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    const int dyn = (int)(kStageMaxBytes < (size_t)d.smem_optin - 64
                              ? kStageMaxBytes
                              : (size_t)d.smem_optin - 64);
    const void* fns[] = {(const void*)fwd_staged_kernel<4>,
                         (const void*)fwd_staged_kernel<1>};
    for (const void* f : fns) {
      err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dyn);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            f, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
    }
    d.ready = true;
  }
  int per_sm = -1;
  for (const FwdOcc& o : g_fwd_occ)
    if (o.fn == fn && o.device == device && o.smem == smem) per_sm = o.per_sm;
  if (per_sm < 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kStageThreads, smem);
    if (err != cudaSuccess) return err;
    g_fwd_occ[g_fwd_occ_next] = {fn, device, smem, per_sm};
    g_fwd_occ_next = (g_fwd_occ_next + 1) % kOccSlots;
  }
  const int need = (groups + kStageThreads - 1) / kStageThreads;
  const int held = d.sms * per_sm;  // 0: the launch fails
  *blocks = need < held ? need : held;
  return cudaSuccess;
}

// ---- backward (K3) --------------------------------------------------------

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortRounds = 8;
constexpr int kSortTile = kSortThreads * kSortRounds;  // keys per sort block
constexpr int kChunk = 512;        // sorted lanes per reduce block
constexpr int kReduceThreads = 256;
constexpr int kReduceWarps = kReduceThreads / 32;
constexpr int kWarpCols = 4;       // columns a warp carries at once
constexpr int kFixupCols = 64;
constexpr int kFixupSplit = 8;
constexpr int kFixupThreads = kFixupCols * kFixupSplit;
constexpr int kZeroBlocks = 132 * 8;

// The sort key of an id: itself, or T for an id outside [0, T), so dropped
// lanes sort behind every row.
__device__ __forceinline__ int sort_key(int id, int n_rows) {
  return (unsigned)id < (unsigned)n_rows ? id : n_rows;
}

__global__ void __launch_bounds__(kThreads)
bwd_zero_kernel(float* __restrict__ out, size_t size) {
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < size;
       k += step)
    out[k] = 0.0f;
}

// One sort pass, step 1: hist[d, b] = keys of block b whose digit is d. The
// first pass (kFirst) reads the raw ids.
template <bool kFirst>
__global__ void __launch_bounds__(kSortThreads)
bwd_sort_hist_kernel(const int* __restrict__ keys_in, int n, int n_rows,
                     int shift, int n_blocks, int* __restrict__ hist) {
  __shared__ int s_hist[kRadix];
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kSortTile;
  for (int r = 0; r < kSortRounds; ++r) {
    const int i = base + r * kSortThreads + threadIdx.x;
    int digit = kRadix;  // lanes past the end share a digit that is not counted
    if (i < n) {
      const int key = kFirst ? sort_key(keys_in[i], n_rows) : keys_in[i];
      digit = (key >> shift) & (kRadix - 1);
    }
    // one atomic per distinct digit of the warp: a run of equal ids (the sky
    // row, a small table) does not serialize on one counter
    const unsigned peers = __match_any_sync(kFull, digit);
    if (digit < kRadix && (peers & ((1u << lane) - 1u)) == 0)
      atomicAdd(&s_hist[digit], __popc(peers));
  }
  __syncthreads();
  hist[(size_t)threadIdx.x * n_blocks + blockIdx.x] = s_hist[threadIdx.x];
}

// Exclusive prefix of x over a block of 256 threads, and the block's total.
// s_sums is int[8] of shared memory, free again on return.
__device__ __forceinline__ int block_scan_256(int x, int* s_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int c = s_sums[w];
    if (w < warp) before += c;
    all += c;
  }
  __syncthreads();
  *total = all;
  return before + incl - x;
}

// Step 2: block d scans digit d's row of hist in place (exclusive, over the
// sort blocks) and writes the digit's total; the scatter adds the totals of
// the lower digits itself. 256 blocks, each over its contiguous row.
__global__ void __launch_bounds__(kSortThreads)
bwd_sort_scan_kernel(int* __restrict__ hist, int n_blocks,
                     int* __restrict__ totals) {
  __shared__ int s_sums[kSortWarps];
  int* row = hist + (size_t)blockIdx.x * n_blocks;
  int carry = 0;
  for (int base = 0; base < n_blocks; base += kSortThreads) {
    const int i = base + threadIdx.x;
    const int x = i < n_blocks ? row[i] : 0;
    int total;
    const int before = block_scan_256(x, s_sums, &total);
    if (i < n_blocks) row[i] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Step 3: stable scatter. A block takes its tile in rounds of 256 keys in
// lane order; in a round a key's place is the block's running offset of its
// digit, plus the equal digits of lower warps, plus those of lower lanes in
// its own warp.
template <bool kFirst>
__global__ void __launch_bounds__(kSortThreads)
bwd_sort_scatter_kernel(const int* __restrict__ keys_in,
                        const int* __restrict__ lanes_in, int n, int n_rows,
                        int shift, int n_blocks, const int* __restrict__ hist,
                        const int* __restrict__ totals,
                        int* __restrict__ keys_out,
                        int* __restrict__ lanes_out) {
  __shared__ int s_run[kRadix];
  __shared__ int s_warp[kSortWarps][kRadix];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {
    // where this block's keys of digit d go: after every key of a lower
    // digit, then after the lower blocks' keys of digit d
    int total;
    const int lower = block_scan_256(totals[threadIdx.x], &s_warp[0][0],
                                     &total);
    s_run[threadIdx.x] =
        lower + hist[(size_t)threadIdx.x * n_blocks + blockIdx.x];
  }
  const int base = blockIdx.x * kSortTile;
  for (int r = 0; r < kSortRounds; ++r) {
    for (int w = 0; w < kSortWarps; ++w) s_warp[w][threadIdx.x] = 0;
    __syncthreads();
    const int i = base + r * kSortThreads + threadIdx.x;
    const bool valid = i < n;
    int key = 0, src = 0;
    if (valid) {
      key = kFirst ? sort_key(keys_in[i], n_rows) : keys_in[i];
      src = kFirst ? i : lanes_in[i];
    }
    // lanes past the end come last in the tile: they share a digit of their
    // own and never count before a valid key
    const int digit = valid ? (key >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(kFull, digit);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (valid && rank == 0) s_warp[warp][digit] = __popc(peers);
    __syncthreads();
    {
      int offset = s_run[threadIdx.x];
      for (int w = 0; w < kSortWarps; ++w) {
        const int c = s_warp[w][threadIdx.x];
        s_warp[w][threadIdx.x] = offset;
        offset += c;
      }
      s_run[threadIdx.x] = offset;
    }
    __syncthreads();
    if (valid) {
      const int dst = s_warp[warp][digit] + rank;
      keys_out[dst] = key;
      lanes_out[dst] = src;
    }
    __syncthreads();
  }
}

// The sum of x over the warp, the same bits in every lane (a butterfly: the
// order is fixed).
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// cot[col, lane] of a sorted position, 0 for a dropped lane or a column past
// the width.
__device__ __forceinline__ float load_cot(const float* __restrict__ cot, int n,
                                          int n_rows, int width, int col,
                                          int key, int lane) {
  return key < n_rows && col < width ? cot[(size_t)col * n + lane] : 0.0f;
}

// Reduce by key over one chunk of the sorted order. row_a is i32[chunks]: the
// row of the chunk's record A, or -1 when no run that began in an earlier
// chunk ends in this one. rec is f64[chunks, 2, W]: A, then B.
__global__ void __launch_bounds__(kReduceThreads)
bwd_reduce_kernel(const int* __restrict__ keys, const int* __restrict__ lanes,
                  const float* __restrict__ cot, int n, int n_rows, int width,
                  float* __restrict__ out, int* __restrict__ row_a,
                  double* __restrict__ rec) {
  // s_key[j] is the key at sorted position base + j - 1: one neighbour on
  // each side says whether the chunk's first and last runs go on outside it
  __shared__ int s_key[kChunk + 2];
  __shared__ int s_lane[kChunk];
  const int chunk = blockIdx.x;
  const int base = chunk * kChunk;
  for (int j = threadIdx.x; j < kChunk + 2; j += blockDim.x) {
    const int p = base + j - 1;
    s_key[j] = p < 0 ? -1 : (p < n ? keys[p] : n_rows);
  }
  for (int j = threadIdx.x; j < kChunk; j += blockDim.x) {
    const int p = base + j;
    s_lane[j] = p < n ? lanes[p] : 0;
  }
  __syncthreads();
  const int first_key = s_key[1], last_key = s_key[kChunk];
  const bool open_left = first_key < n_rows && s_key[0] == first_key;
  const bool open_right = last_key < n_rows && s_key[kChunk + 1] == last_key;
  const bool whole = first_key == last_key;
  if (threadIdx.x == 0)
    row_a[chunk] = open_left && !(whole && open_right) ? first_key : -1;
  if (first_key >= n_rows) return;  // only dropped lanes from here on

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned le_mask = kFull >> (31 - lane);
  double* rec_a = rec + (size_t)chunk * 2 * width;
  double* rec_b = rec_a + width;
  for (int c0 = 0; c0 < width; c0 += kReduceWarps * kWarpCols) {
    // The open run's sum so far is carry + the sum of acc over the warp: a
    // group of 32 lanes that lies inside one run only adds into its lanes'
    // acc (no shuffles: the sky row, every row of a small table); a group
    // with a run boundary folds acc into carry and scans.
    double carry[kWarpCols], acc[kWarpCols];
    float next[kWarpCols];
#pragma unroll
    for (int u = 0; u < kWarpCols; ++u) {
      carry[u] = acc[u] = 0.0;
      const int col = c0 + warp + kReduceWarps * u;
      next[u] = load_cot(cot, n, n_rows, width, col, s_key[lane + 1],
                         s_lane[lane]);
    }
    bool pending = false;  // acc holds something (the same in every lane)
    for (int g = 0; g < kChunk / 32; ++g) {
      const int j = g * 32 + lane;
      const int key = s_key[j + 1];
      const bool valid = key < n_rows;
      const unsigned heads = __ballot_sync(kFull, key != s_key[j]);
      const bool tail = key != s_key[j + 2];
      const unsigned tails = __ballot_sync(kFull, tail);
      double v[kWarpCols];
#pragma unroll
      for (int u = 0; u < kWarpCols; ++u) {
        v[u] = (double)next[u];
        if (g + 1 < kChunk / 32) {
          const int col = c0 + warp + kReduceWarps * u;
          next[u] = load_cot(cot, n, n_rows, width, col, s_key[j + 33],
                             s_lane[j + 32]);
        }
      }
      if (heads == 0 && tails == 0) {  // inside one run
#pragma unroll
        for (int u = 0; u < kWarpCols; ++u) acc[u] += v[u];
        pending = true;
        continue;
      }
      if (pending) {
#pragma unroll
        for (int u = 0; u < kWarpCols; ++u) {
          carry[u] += warp_sum(acc[u]);
          acc[u] = 0.0;
        }
        pending = false;
      }
      // the lane where my run starts within these 32, and whether that run
      // came in from the 32 before (then the carry belongs to it)
      const int head_lane = 31 - __clz((heads | 1u) & le_mask);
      const bool continues = head_lane == 0 && !(heads & 1u);
      const bool to_record = open_left && key == first_key;
#pragma unroll
      for (int u = 0; u < kWarpCols; ++u) {
        const int col = c0 + warp + kReduceWarps * u;
        double s = v[u];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const double t = __shfl_up_sync(kFull, s, d);
          if (lane - d >= head_lane) s += t;
        }
        if (continues) s += carry[u];
        if (valid && tail && col < width) {
          if (to_record)
            rec_a[col] = s;
          else
            out[(size_t)key * width + col] = (float)s;
        }
        const double last = __shfl_sync(kFull, s, 31);
        carry[u] = (tails >> 31) ? 0.0 : last;
      }
    }
    if (open_right) {
#pragma unroll
      for (int u = 0; u < kWarpCols; ++u) {
        const int col = c0 + warp + kReduceWarps * u;
        const double s = carry[u] + warp_sum(acc[u]);
        if (lane == 0 && col < width) rec_b[col] = s;
      }
    }
  }
}

// A row that spans chunks, one block per record A: the run began at the first
// sorted position that holds its key (a binary search, the same in every
// thread); every chunk from that one up to this one wrote the run's partial
// as its record B. Eight threads per column each add every eighth of those
// records in ascending chunk order; the eight partials and then the record A
// of the chunk where the run ends are added in that order, so the sum depends
// on the ids alone.
__global__ void __launch_bounds__(kFixupThreads)
bwd_fixup_kernel(const int* __restrict__ keys, const int* __restrict__ row_a,
                 const double* __restrict__ rec, int width,
                 float* __restrict__ out) {
  __shared__ double s_part[kFixupSplit][kFixupCols];
  const int chunk = blockIdx.x;
  const int key = row_a[chunk];
  if (key < 0) return;
  int lo = 0, hi = chunk * kChunk - 1;  // keys[hi] == key
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  const int first = lo / kChunk;
  const int c = threadIdx.x % kFixupCols, part = threadIdx.x / kFixupCols;
  for (int c0 = 0; c0 < width; c0 += kFixupCols) {
    const int col = c0 + c;
    double s = 0.0;
    if (col < width) {
#pragma unroll 4
      for (int k = first + part; k < chunk; k += kFixupSplit)
        s += rec[((size_t)k * 2 + 1) * width + col];
    }
    s_part[part][c] = s;
    __syncthreads();
    if (part == 0 && col < width) {
      double total = 0.0;
#pragma unroll
      for (int q = 0; q < kFixupSplit; ++q) total += s_part[q][c];
      total += rec[(size_t)chunk * 2 * width + col];
      out[(size_t)key * width + col] = (float)total;
    }
    __syncthreads();
  }
}

}  // namespace

// idx i32[n], table f32[n_rows, width], out f32[width, n]; all on the
// current device. The path follows from the table's size, the staged
// path's copy and store widths from alignment.
extern "C" int pbr_packgather_fwd(const int* idx, const float* table, int n,
                                  int n_rows, int width, float* out,
                                  void* stream_ptr) {
  if (n <= 0 || width <= 0) return (int)cudaSuccess;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int blocks = 0;
  cudaError_t err;
  const size_t staged = ((size_t)n_rows + 1) * width * sizeof(float);
  if (n_rows >= 0 && staged <= kStageMaxBytes) {
    const bool vec = n % 4 == 0 && (uintptr_t)idx % 16 == 0 &&
                     (uintptr_t)out % 16 == 0;
    const int bulk =
        (uintptr_t)table % 16 == 0
            ? (int)(((size_t)n_rows * width * sizeof(float)) & ~(size_t)15)
            : 0;
    if (vec) {
      err = staged_blocks((const void*)fwd_staged_kernel<4>, staged, n / 4,
                          &blocks);
      if (err != cudaSuccess) return (int)err;
      fwd_staged_kernel<4><<<blocks, kStageThreads, staged, stream>>>(
          idx, table, n, n_rows, width, bulk, out);
    } else {
      err = staged_blocks((const void*)fwd_staged_kernel<1>, staged, n,
                          &blocks);
      if (err != cudaSuccess) return (int)err;
      fwd_staged_kernel<1><<<blocks, kStageThreads, staged, stream>>>(
          idx, table, n, n_rows, width, bulk, out);
    }
  } else {
    fwd_in_place_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(idx, table, n, n_rows, width, out);
  }
  return (int)cudaGetLastError();
}

// cot is f32[W, N], out f32[T, W]. sort_tile, chunk and passes are the
// caller's plan (kernels/packgather.py::bwd_plan) and must be this file's.
// scratch_i is caller-allocated, 4 n + 256 ceil(n / sort_tile) +
// 256 + ceil(n / chunk) ints: two (keys, lanes) buffers, the histograms, the
// digit totals, the rows of the A records; scratch_d is 2 ceil(n / chunk) W
// doubles of records.
extern "C" int pbr_packgather_bwd(const int* idx, const float* cot, int n,
                                  int n_rows, int width, int sort_tile,
                                  int chunk, int passes, int* scratch_i,
                                  double* scratch_d, float* out,
                                  void* stream_ptr) {
  if (n_rows <= 0 || width <= 0) return (int)cudaSuccess;
  int need = 1;
  while (need < 4 && (n_rows >> (kRadixBits * need)) != 0) ++need;
  if (sort_tile != kSortTile || chunk != kChunk || passes != need || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t size = (size_t)n_rows * width;
  const int zero_blocks =
      (int)((size + kThreads - 1) / kThreads < (size_t)kZeroBlocks
                ? (size + kThreads - 1) / kThreads
                : (size_t)kZeroBlocks);
  bwd_zero_kernel<<<zero_blocks, kThreads, 0, stream>>>(out, size);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;

  const int sort_blocks = (n + kSortTile - 1) / kSortTile;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  int* keys[2] = {scratch_i, scratch_i + 2 * (size_t)n};
  int* lanes[2] = {scratch_i + (size_t)n, scratch_i + 3 * (size_t)n};
  int* hist = scratch_i + 4 * (size_t)n;
  int* totals = hist + (size_t)kRadix * sort_blocks;
  int* row_a = totals + kRadix;
  const int* keys_in = idx;
  const int* lanes_in = nullptr;
  for (int p = 0; p < passes; ++p) {
    const int shift = kRadixBits * p;
    int* keys_out = keys[p & 1];
    int* lanes_out = lanes[p & 1];
    if (p == 0) {
      bwd_sort_hist_kernel<true><<<sort_blocks, kSortThreads, 0, stream>>>(
          keys_in, n, n_rows, shift, sort_blocks, hist);
    } else {
      bwd_sort_hist_kernel<false><<<sort_blocks, kSortThreads, 0, stream>>>(
          keys_in, n, n_rows, shift, sort_blocks, hist);
    }
    bwd_sort_scan_kernel<<<kRadix, kSortThreads, 0, stream>>>(
        hist, sort_blocks, totals);
    if (p == 0) {
      bwd_sort_scatter_kernel<true><<<sort_blocks, kSortThreads, 0, stream>>>(
          keys_in, lanes_in, n, n_rows, shift, sort_blocks, hist, totals,
          keys_out, lanes_out);
    } else {
      bwd_sort_scatter_kernel<false><<<sort_blocks, kSortThreads, 0, stream>>>(
          keys_in, lanes_in, n, n_rows, shift, sort_blocks, hist, totals,
          keys_out, lanes_out);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    keys_in = keys_out;
    lanes_in = lanes_out;
  }
  bwd_reduce_kernel<<<n_chunks, kReduceThreads, 0, stream>>>(
      keys_in, lanes_in, cot, n, n_rows, width, out, row_a, scratch_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_fixup_kernel<<<n_chunks, kFixupThreads, 0, stream>>>(
      keys_in, row_a, scratch_d, width, out);
  return (int)cudaGetLastError();
}

// Timestamps of the port's device spans (utils/observability.py).
//
// A span's two ends are one-thread kernels that write the card's global
// nanosecond timer into a slot of a device buffer. Captured into a CUDA
// graph, each is a kernel node, which the graph's executable keeps
// disabled (an empty node) while tracing is off: pbr_stamp hands back the
// node it captured, pbr_nodes_enable switches a list of them.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

}  // namespace

// Write the timer into *slot on `stream`. Under stream capture, *node is
// the kernel node that the launch added to the graph; otherwise null.
extern "C" int pbr_stamp(unsigned long long* slot, void* stream,
                         void** node) {
  *node = nullptr;
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr,
                                 nullptr, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  if (status == cudaStreamCaptureStatusActive && n == 1) *node = deps[0];
  return (int)cudaSuccess;
}

// Enable (enable != 0) or disable the `n` nodes of the executable graph
// `exec`; the change holds for the launches that follow.
extern "C" int pbr_nodes_enable(void* exec, void* const* nodes, int n,
                                int enable) {
  for (int i = 0; i < n; ++i) {
    cudaError_t err = cudaGraphNodeSetEnabled(
        (cudaGraphExec_t)exec, (cudaGraphNode_t)nodes[i], enable ? 1u : 0u);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// What csrc/shade.cu takes from the CUDA runtime, for a host build of it
// (g++ -I tests/shade_host): the qualifiers vanish, the grid's indices are
// globals that the launch loop sets, and rsqrtf is 1 / sqrtf. The CPU tests
// build it so (tests/test_torch_shade_fused.py).
#pragma once

#include <algorithm>
#include <cmath>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)

using std::isnan;
using std::max;
using std::min;

enum { cudaSuccess = 0 };

struct HostIndex {
  long long x;
};

static HostIndex blockIdx, threadIdx;

inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }

// A CTA-wide exclusive scan, shared by the kernels that cut their input
// into tiles (csrc/rle2.cu, csrc/bwt.cu).
#pragma once

#include <cuda_runtime.h>

namespace tpubz {

struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct Min {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Exclusive scan of v across the CTA (blockDim.x a multiple of 32, at most
// 1024) under op, identity for the first thread; *total gets the CTA's
// whole. `sh` holds 32 ints and is free again on return.
template <typename Op>
__device__ int block_exclusive(int v, int identity, Op op, int* sh, int* total) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = op(incl, o);
  }
  if (lane == 31) sh[w] = incl;
  __syncthreads();
  int before = identity, all = identity;
  for (int p = 0; p < nw; ++p) {
    if (p < w) before = op(before, sh[p]);
    all = op(all, sh[p]);
  }
  __syncthreads();
  const int prev = __shfl_up_sync(kFull, incl, 1);
  *total = all;
  return lane ? op(before, prev) : before;
}

}  // namespace tpubz

// MTF ranks within each 256-wide chunk: the dominance count, fused with the
// chunk-start rank count.
//
// Replaces the TPU kernel tpubz/kernels/mtf_pallas.py:dominance_ranks (body
// _kernel) together with the srank compare-count that
// tpubz/kernels/mtf.py:_ranks_from_parts computes in XLA before calling it.
// For position i of a chunk, with srank_i = #{s : keyrow[s] < keyi_i}:
//
//   lprev_i >= 0 (previous occurrence in the chunk):
//       rank_i = #{j < i : j > lprev_i, lnext_j >= i}
//   lprev_i <  0 (first occurrence in the chunk):
//       rank_i = srank_i + #{j < i : lprev_j < 0, srank_j >= srank_i}
//
// Design: one CTA per chunk and one thread per position. The chunk's lprev,
// lnext and keyrow rows and the computed srank row sit in shared memory
// (4 KB), so the 256 x 256 compare matrices of the TPU formulation never
// exist anywhere: each thread runs its own counts from shared memory, where
// the j-loop reads are broadcasts. Nothing carries between CTAs, so the TPU
// kernel's padding of the chunk rows to a group of 8 is gone.
//
// What bounds it on an H100: at level 9 (nc = 3516 chunks) it reads 4 x 3.6 MB
// and writes 3.6 MB, and does about 3516 x 256 x 512 integer compares. That
// is microseconds of bandwidth and of ALU throughput; with 3516 CTAs of 256
// threads over 132 SMs it is bound by latency (the serial j-loops of up to
// 512 steps per thread) and by the launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 256;

__global__ void __launch_bounds__(kChunk)
    mtf_dominance_kernel(const int32_t* __restrict__ lprev,
                         const int32_t* __restrict__ lnext,
                         const int32_t* __restrict__ keyi,
                         const int32_t* __restrict__ keyrow,
                         int32_t* __restrict__ ranks) {
  __shared__ int32_t s_lprev[kChunk];
  __shared__ int32_t s_lnext[kChunk];
  __shared__ int32_t s_keyrow[kChunk];
  __shared__ int32_t s_srank[kChunk];

  const int i = threadIdx.x;
  const size_t at = static_cast<size_t>(blockIdx.x) * kChunk + i;
  const int lp = lprev[at];
  const int ki = keyi[at];
  s_lprev[i] = lp;
  s_lnext[i] = lnext[at];
  s_keyrow[i] = keyrow[at];
  __syncthreads();

  // chunk-start MTF rank of this position's symbol: used symbols with a
  // smaller recency key (unused symbols carry the largest keys)
  int srank = 0;
  for (int s = 0; s < kChunk; ++s) srank += s_keyrow[s] < ki;
  s_srank[i] = srank;
  __syncthreads();

  int count = 0;
  if (lp >= 0) {
    // distinct symbols seen since the previous occurrence: positions in
    // (lprev_i, i) that are the last occurrence of their symbol before i
    for (int j = lp + 1; j < i; ++j) count += s_lnext[j] >= i;
  } else {
    // symbols first seen in this chunk before i moved in front of this one
    // iff they ranked behind it at the chunk start
    for (int j = 0; j < i; ++j)
      count += (s_lprev[j] < 0) & (s_srank[j] >= srank);
    count += srank;
  }
  ranks[at] = count;
}

}  // namespace

// lprev, lnext, keyi, keyrow, ranks: device pointers to int32 (nc, 256),
// row-major and contiguous. Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int tpubz_mtf_dominance(const void* lprev, const void* lnext,
                                   const void* keyi, const void* keyrow,
                                   void* ranks, int nc, void* stream) {
  if (nc > 0) {
    mtf_dominance_kernel<<<nc, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(lprev), static_cast<const int32_t*>(lnext),
        static_cast<const int32_t*>(keyi), static_cast<const int32_t*>(keyrow),
        static_cast<int32_t*>(ranks));
  }
  return static_cast<int>(cudaGetLastError());
}

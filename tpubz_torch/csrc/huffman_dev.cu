// The device half of the Huffman refinement: the per-group histograms of a
// block's RLE2 symbols, and one refinement pass over them (each group's
// cheapest table, and each table's symbol frequencies over the groups that
// chose it), one kernel launched by one library call each.
//
// Replaces tpubz/kernels/huffman_dev.py:chunk_hist and chunk_hist_batch (a
// scatter-add of ones at (i // 50) * 258 + syms[i] for i < rle2_len) and
// refine_pass (two float32 matmuls on the MXU, cost = hist . lens^T and
// rfreq = onehot(sel)^T . hist, with an argmin between them). Their outputs,
// bit for bit:
//   hist[g, s]  = #{i in [50g, 50g + 50) : i < rle2_len, syms[i] = s}, rows
//                 past the stream all zero;
//   sel[g]      = the t < table_count with the least
//                 cost[g, t] = sum_s hist[g, s] * lens[t, s], ties to the
//                 lowest t (tpubz masks t >= table_count by adding 3e8 to
//                 the cost, so its stale rows of 15s never win; here they
//                 are left out by index), so an all-zero row selects 0;
//   rfreq[t, s] = sum over g with sel[g] = t of hist[g, s].
// The costs are integers (counts <= 50, lengths <= 20), so integer
// arithmetic gives tpubz's exact float sums, with no tensor core and no TF32.
//
//   chunk_hist_rows  one warp a group: its 258-bin row in shared memory,
//                    zeroed, at most 50 shared atomics, then the whole row
//                    stored with coalesced writes, zeros included, so the
//                    18.6 MB histogram of a level-9 block needs no memset.
//                    The row of a batch is grid dimension y.
//   refine_rows      the lengths of the 6 tables in shared memory; one warp a
//                    group (grid-stride): each lane holds 9 of the row's 258
//                    counts, six integer dot products reduced across the
//                    warp, a strict-< scan over t ascending; the row's counts
//                    go into the CTA's 6 x 258 frequencies in shared memory,
//                    and the CTA's non-zero sums into rfreq (zeroed by the
//                    call) by integer atomics, exact in any order.
//
// What bounds it on an H100: chunk_hist writes the histogram (18.58 MB at
// level 9: 18,003 groups x 258 x 4 bytes) and reads the symbols (3.60 MB),
// 6.6 us at 3.35 TB/s; refine_pass reads the histogram once (5.5 us) and
// does 6 x 258 multiply-adds a group (55.7 M integer operations, 3.3 us at
// the int32 rate). Both are bound by memory; the histogram's size, not the
// arithmetic, is the cost of this formulation.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 50;    // symbols a selector covers
constexpr int kAlpha = 258;   // a table's symbols
constexpr int kTables = 6;
constexpr int kHistWarps = 8;     // groups a CTA of chunk_hist_rows
constexpr int kRefineWarps = 16;  // warps a CTA of refine_rows
constexpr int kRefineCtas = 264;  // at most: two a streaming multiprocessor
constexpr int kLaneBins = (kAlpha + 31) / 32;  // 9
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long row_length(const void* len, int len_bytes, int row) {
  return len_bytes == 8 ? static_cast<const long long*>(len)[row]
                        : static_cast<const int*>(len)[row];
}

template <typename SymT>
__global__ void __launch_bounds__(kHistWarps * 32)
    chunk_hist_rows(const SymT* __restrict__ syms, const void* rle2_len, int len_bytes,
                    int out_len, int nsel, int32_t* __restrict__ hist) {
  __shared__ int s_hist[kHistWarps][kAlpha];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kHistWarps + warp;
  if (g >= nsel) return;  // a whole warp: the others synchronise by warp only
  const size_t row = blockIdx.y;
  int* h = s_hist[warp];
  for (int s = lane; s < kAlpha; s += 32) h[s] = 0;
  __syncwarp();
  const long long len = row_length(rle2_len, len_bytes, static_cast<int>(row));
  syms += row * out_len;
  for (int k = lane; k < kGroup; k += 32) {
    const int i = g * kGroup + k;
    if (i < out_len && i < len) {
      const int s = syms[i];
      if (static_cast<unsigned>(s) < kAlpha) atomicAdd(h + s, 1);
    }
  }
  __syncwarp();
  int32_t* out = hist + (row * nsel + g) * kAlpha;
  for (int s = lane; s < kAlpha; s += 32) out[s] = h[s];
}

__global__ void __launch_bounds__(kRefineWarps * 32)
    refine_rows(const int32_t* __restrict__ hist, const int32_t* __restrict__ lens,
                int table_count, int nsel, int8_t* __restrict__ sel, int32_t* rfreq) {
  __shared__ int s_lens[kTables * kAlpha];
  __shared__ int s_rfreq[kTables * kAlpha];
  for (int k = threadIdx.x; k < kTables * kAlpha; k += blockDim.x) {
    s_lens[k] = lens[k];
    s_rfreq[k] = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * kRefineWarps;
  for (int g = blockIdx.x * kRefineWarps + warp; g < nsel; g += stride) {
    const int32_t* h = hist + static_cast<size_t>(g) * kAlpha;
    int hv[kLaneBins];
#pragma unroll
    for (int j = 0; j < kLaneBins; ++j) {
      const int s = lane + 32 * j;
      hv[j] = s < kAlpha ? h[s] : 0;
    }
    int cost[kTables];
#pragma unroll
    for (int t = 0; t < kTables; ++t) {
      int c = 0;
#pragma unroll
      for (int j = 0; j < kLaneBins; ++j) {
        const int s = lane + 32 * j;
        if (s < kAlpha) c += hv[j] * s_lens[t * kAlpha + s];
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
      cost[t] = c;
    }
    int best = 0;
#pragma unroll
    for (int t = 1; t < kTables; ++t) {
      if (t < table_count && cost[t] < cost[best]) best = t;
    }
    if (lane == 0) sel[g] = static_cast<int8_t>(best);
#pragma unroll
    for (int j = 0; j < kLaneBins; ++j) {
      if (hv[j]) atomicAdd(s_rfreq + best * kAlpha + lane + 32 * j, hv[j]);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kTables * kAlpha; k += blockDim.x) {
    if (s_rfreq[k]) atomicAdd(rfreq + k, s_rfreq[k]);
  }
}

}  // namespace

// syms: device symbols [B, out_len], int32 (sym_bytes 4) or uint16 (2); row
// b's first rle2_len[b] (device int64 or int32, len_bytes 8 or 4) the stream.
// hist: device int32[B, ceil(out_len / 50), 258]. Launches the kernel on
// `stream` and returns cudaGetLastError() as an int (0 on success).
extern "C" int tpubz_chunk_hist(const void* syms, int sym_bytes, const void* rle2_len,
                                int len_bytes, int B, int out_len, void* hist, void* stream) {
  if (B < 1 || B > 65535 || out_len < 1 || out_len >= (1 << 30) ||
      (sym_bytes != 4 && sym_bytes != 2) || (len_bytes != 8 && len_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int nsel = (out_len + kGroup - 1) / kGroup;
  const dim3 grid((nsel + kHistWarps - 1) / kHistWarps, B);
  if (sym_bytes == 4) {
    chunk_hist_rows<<<grid, kHistWarps * 32, 0, st>>>(static_cast<const int32_t*>(syms), rle2_len,
                                                      len_bytes, out_len, nsel,
                                                      static_cast<int32_t*>(hist));
  } else {
    chunk_hist_rows<<<grid, kHistWarps * 32, 0, st>>>(static_cast<const uint16_t*>(syms),
                                                      rle2_len, len_bytes, out_len, nsel,
                                                      static_cast<int32_t*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}

// hist: device int32[nsel, 258]; lens: device int32[6, 258]; 1 <= table_count
// <= 6. sel: device int8[nsel]; rfreq: device int32[6, 258], zeroed here.
// Launches the kernel on `stream` and returns cudaGetLastError() as an int.
extern "C" int tpubz_refine_pass(const void* hist, const void* lens, int table_count, int nsel,
                                 void* sel, void* rfreq, void* stream) {
  if (nsel < 1 || table_count < 1 || table_count > kTables) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = cudaMemsetAsync(rfreq, 0, 4 * kTables * kAlpha, st)) {
    return static_cast<int>(e);
  }
  int ctas = (nsel + kRefineWarps - 1) / kRefineWarps;
  if (ctas > kRefineCtas) ctas = kRefineCtas;
  refine_rows<<<ctas, kRefineWarps * 32, 0, st>>>(
      static_cast<const int32_t*>(hist), static_cast<const int32_t*>(lens), table_count, nsel,
      static_cast<int8_t*>(sel), static_cast<int32_t*>(rfreq));
  return static_cast<int>(cudaGetLastError());
}

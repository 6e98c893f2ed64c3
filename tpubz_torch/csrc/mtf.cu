// Move-to-front ranks of a BWT last column on the card: the whole MTF in
// three kernels, launched by one library call.
//
// Replaces the TPU kernel tpubz/kernels/mtf_pallas.py:dominance_ranks
// (pallas_call, body _kernel) and the XLA around it in
// tpubz/kernels/mtf.py:mtf_ranks: the two (symbol, position) sorts of
// _prev_next, the last-occurrence scatter into (nc, 257), the running max
// over chunks (associative_scan), the initial ranks, and the srank
// compare-count of _ranks_from_parts. Only mtf_ranks' outputs are the
// contract: ranks[:n] and used, bit for bit. Pad lanes (n <= i < N) get 0.
//
// The formulation is tpubz's (see tpubz/kernels/mtf.py): within a chunk of
// 256 positions, position i with symbol s ranks
//   previous occurrence in the chunk at lprev_i:
//       #{j in (lprev_i, i) : lnext_j >= i}   (distinct symbols since then)
//   first occurrence in the chunk:
//       srank(s) + #{first-in-chunk j < i : srank(sym_j) > srank(s)}
// where srank(s) is s's MTF rank at the chunk start: its rank among the used
// symbols by the recency key N - last_before[c, s] (seen before the chunk)
// or 2N + init_rank[s] (not yet seen).
//
// The kernels:
//   mtf_group_last    one CTA per group of `group` chunks walks them in
//                     order with the group's running last occurrence per
//                     symbol in shared memory (a warp-level match, then one
//                     shared atomicMax per symbol and warp), writing each
//                     chunk's in-group exclusive row and the group's total.
//   mtf_group_prefix  8 CTAs of 32 columns by 32 row slices scan the group
//                     totals: each group's exclusive prefix and the used map.
//   mtf_chunk_ranks   one CTA per chunk, one thread per position. It forms
//                     the initial ranks (a ballot scan of the used map) and
//                     the chunk's 256 recency keys, sorts the keys (a
//                     bitonic network: shuffles within a warp, shared memory
//                     across warps) to get srank once per symbol, finds
//                     lprev and lnext with a warp-level match and each
//                     symbol's first and last position per warp, compacts
//                     the first-in-chunk positions with a ballot scan, then
//                     counts case 1 over (lprev_i, i) and case 2 over the
//                     compacted list only.
//
// The batched call (tpubz_mtf_ranks_batch, the counterpart of
// tpubz/kernels/mtf.py:mtf_ranks_batch, whose dominance count reaches the
// Pallas kernel with rows = B * nc) launches the same three kernels with
// the row as grid dimension y: each row has its own bytes, length, scratch
// rows, used map and ranks, and the running last occurrence starts afresh
// in every row, as tpubz resets its max-scan per block.
//
// What bounds it on an H100: its inputs and outputs are N bytes in and 4N
// bytes of ranks out (4.5 MB at level 9, 1.34 us at 3.35 TB/s); the
// kernels move about 13 MB between them (the in-group rows are written
// once and read once), mostly through the 50 MB L2. The work is integer
// instructions at 64 lanes a clock per SM: one 36-pass sort, a match and
// two short loops per chunk. The dominance kernel this replaces ran 512
// serial compare steps per thread (the srank count over 256 keys and the
// case-2 count over every j < i) on parts that cost a stable torch.sort,
// scatters and a 2-D cummax to build.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 256;       // positions per chunk = threads per CTA
constexpr int kMaxGroup = 16;     // chunks one mtf_group_last CTA walks, at most
constexpr int kPrefixCols = 32;    // columns one mtf_group_prefix CTA scans
constexpr int kPrefixSlices = 32;  // its row slices, a warp each
constexpr int kWarps = kChunk / 32;
constexpr int kAbsent = 256;      // the initial rank of an unused symbol
constexpr unsigned kFull = 0xffffffffu;

// The length of the CTA's row: n_rows[row] where the call has a device
// array of them, else n.
__device__ __forceinline__ int row_length(int n, const int32_t* n_rows) {
  return n_rows != nullptr ? n_rows[blockIdx.y] : n;
}

__global__ void __launch_bounds__(kChunk)
    mtf_group_last(const uint8_t* __restrict__ last, int n, const int32_t* __restrict__ n_rows,
                   int nc, int group, int32_t* __restrict__ lb_local, int32_t* __restrict__ gmax) {
  __shared__ int32_t run[kChunk];  // last position of each symbol so far
  const size_t row = blockIdx.y;
  n = row_length(n, n_rows);
  last += row * nc * kChunk;
  lb_local += row * nc * kChunk;
  gmax += row * gridDim.x * kChunk;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int c0 = blockIdx.x * group;
  const int chunks = min(group, nc - c0);
  // every byte of the group first, so the walk waits on no load
  int sym[kMaxGroup];
#pragma unroll
  for (int q = 0; q < kMaxGroup; ++q) {
    const int pos = (c0 + q) * kChunk + t;
    sym[q] = (q < chunks && pos < n) ? last[pos] : -1;
  }
  run[t] = -1;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kMaxGroup; ++q) {
    if (q >= chunks) break;
    const int c = c0 + q;
    lb_local[static_cast<size_t>(c) * kChunk + t] = run[t];
    __syncthreads();
    // lanes of one warp with one symbol: the highest holds their largest
    // position and alone updates the table
    const int s = sym[q];
    const unsigned peers = __match_any_sync(kFull, s);
    if (s >= 0 && 31 - __clz(peers) == lane) atomicMax(&run[s], c * kChunk + t);
    __syncthreads();
  }
  gmax[static_cast<size_t>(blockIdx.x) * kChunk + t] = run[t];
}

__global__ void __launch_bounds__(kPrefixCols* kPrefixSlices)
    mtf_group_prefix(const int32_t* __restrict__ gmax, int ng, int32_t* __restrict__ gpre,
                     uint8_t* __restrict__ used) {
  __shared__ int32_t part[kPrefixSlices][kPrefixCols];
  const size_t row = blockIdx.y;
  gmax += row * ng * kChunk;
  gpre += row * ng * kChunk;
  used += row * kChunk;
  const int col = threadIdx.x % kPrefixCols;
  const int q = threadIdx.x / kPrefixCols;  // a warp per slice of rows
  const int s = blockIdx.x * kPrefixCols + col;
  const int per = (ng + kPrefixSlices - 1) / kPrefixSlices;
  const int r0 = min(q * per, ng), r1 = min(r0 + per, ng);
  int m = -1;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) m = max(m, gmax[static_cast<size_t>(r) * kChunk + s]);
  part[q][col] = m;
  __syncthreads();
  int carry = -1, total = -1;
#pragma unroll 8
  for (int p = 0; p < kPrefixSlices; ++p) {
    if (p < q) carry = max(carry, part[p][col]);
    total = max(total, part[p][col]);
  }
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const size_t at = static_cast<size_t>(r) * kChunk + s;
    const int v = gmax[at];
    gpre[at] = carry;
    carry = max(carry, v);
  }
  if (q == 0) used[s] = total >= 0;
}

// 256 distinct values, one a thread, sorted across the CTA: thread t gets
// the t-th smallest. A bitonic network; partners in the warp by shuffle,
// across warps through `sh` (256 ints), which is free again on return.
__device__ __forceinline__ int block_sort256(int v, int* sh) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 2; k <= kChunk; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      int other;
      if (j >= 32) {
        sh[t] = v;
        __syncthreads();
        other = sh[t ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(kFull, v, j);
      }
      // the lower index of a pair keeps the min in an ascending block
      const bool ascending = (t & k) == 0;
      const bool lower = (t & j) == 0;
      v = lower == ascending ? min(v, other) : max(v, other);
    }
  }
  return v;
}

__global__ void __launch_bounds__(kChunk)
    mtf_chunk_ranks(const uint8_t* __restrict__ last, int n, const int32_t* __restrict__ n_rows,
                    int N, int group, const int32_t* __restrict__ lb_local,
                    const int32_t* __restrict__ gpre, const uint8_t* __restrict__ used,
                    int32_t* __restrict__ ranks) {
  __shared__ int32_t sh[kChunk];
  __shared__ int32_t s_srank[kChunk];  // chunk-start MTF rank of each symbol
  __shared__ int32_t s_lnext[kChunk];
  __shared__ int32_t s_first[kChunk];  // sranks of first-in-chunk positions, in order
  __shared__ uint32_t s_warps[kChunk + 1];  // the warps holding each symbol (256: pad lanes)
  __shared__ uint8_t s_first_at[kWarps][kChunk + 1];  // a symbol's first position in a warp
  __shared__ uint8_t s_last_at[kWarps][kChunk + 1];   // and its last
  __shared__ int32_t s_used[kWarps];
  __shared__ int32_t s_count[kWarps];
  const size_t row = blockIdx.y;
  n = row_length(n, n_rows);
  last += row * N;
  lb_local += row * N;
  gpre += row * ((gridDim.x + group - 1) / group) * kChunk;
  used += row * kChunk;
  ranks += row * N;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const unsigned below = (1u << lane) - 1;
  const int c = blockIdx.x;
  const int pos = c * kChunk + t;
  const bool valid = pos < n;
  const int sym = valid ? last[pos] : kChunk;  // pad lanes: a symbol of their own

  // initial rank of symbol t: #{used s < t} (a ballot scan), 256 if unused
  const bool u = used[t];
  const unsigned ub = __ballot_sync(kFull, u);
  if (lane == 0) s_used[w] = __popc(ub);
  s_warps[t] = 0;
  if (t == 0) s_warps[kChunk] = 0;
  __syncthreads();
  int init = __popc(ub & below);
  for (int p = 0; p < w; ++p) init += s_used[p];

  // recency key of symbol t at the chunk start; its rank among the keys
  // (unused symbols carry the largest, so used ones rank among themselves)
  const int before = max(lb_local[static_cast<size_t>(c) * kChunk + t],
                         gpre[static_cast<size_t>(c / group) * kChunk + t]);
  const int key = before >= 0 ? N - before : 2 * N + (u ? init : kAbsent);
  const int ks = block_sort256((key << 8) | t, sh);
  s_srank[ks & 0xff] = t;

  // previous and next occurrence in the chunk: within the warp from a
  // match of the lanes, across warps from the first and last position of
  // each symbol in each warp
  const unsigned peers = __match_any_sync(kFull, sym);
  const unsigned lower = peers & below;
  const unsigned higher = peers & ~below & ~(1u << lane);
  if (!lower) {
    atomicOr(&s_warps[sym], 1u << w);
    s_first_at[w][sym] = t;
    s_last_at[w][sym] = w * 32 + 31 - __clz(peers);
  }
  __syncthreads();
  int lp = lower ? w * 32 + 31 - __clz(lower) : -1;
  int ln = higher ? w * 32 + __ffs(higher) - 1 : kChunk;
  if (!lower) {
    const unsigned m = s_warps[sym] & ((1u << w) - 1);
    if (m) lp = s_last_at[31 - __clz(m)][sym];
  }
  if (!higher) {
    const unsigned m = s_warps[sym] & ~((2u << w) - 1);
    if (m) ln = s_first_at[__ffs(m) - 1][sym];
  }
  s_lnext[t] = ln;

  // the first-in-chunk positions, compacted in position order
  const bool first = valid && lp < 0;
  const unsigned bal = __ballot_sync(kFull, first);
  if (lane == 0) s_count[w] = __popc(bal);
  __syncthreads();
  int idx = __popc(bal & below);
  for (int p = 0; p < w; ++p) idx += s_count[p];
  const int srank = first ? s_srank[sym] : 0;
  if (first) s_first[idx] = srank;
  __syncthreads();

  int rank = 0;
  if (valid) {
    if (lp >= 0) {
      // positions in (lprev_i, i) that are their symbol's last before i
      for (int j = lp + 1; j < t; ++j) rank += s_lnext[j] >= t;
    } else {
      // symbols first seen in this chunk before i moved in front of this
      // one iff they ranked behind it at the chunk start
      rank = srank;
      for (int f = 0; f < idx; ++f) rank += s_first[f] > srank;
    }
  }
  ranks[pos] = rank;
}

// The three launches over B rows of N bytes; row b's length is n_rows[b]
// (device) where n_rows is given, else n.
int enqueue_mtf(const uint8_t* last, int n, const int32_t* n_rows, int B, int N, int group,
                int32_t* scratch, uint8_t* used, int32_t* ranks, cudaStream_t st) {
  const int nc = N / kChunk;
  const int ng = (nc + group - 1) / group;
  int32_t* lb_local = scratch;
  int32_t* gmax = lb_local + static_cast<size_t>(B) * nc * kChunk;
  int32_t* gpre = gmax + static_cast<size_t>(B) * ng * kChunk;
  if (nc > 0) {
    mtf_group_last<<<dim3(ng, B), kChunk, 0, st>>>(last, n, n_rows, nc, group, lb_local, gmax);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  mtf_group_prefix<<<dim3(kChunk / kPrefixCols, B), kPrefixCols * kPrefixSlices, 0, st>>>(
      gmax, ng, gpre, used);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (nc > 0) {
    mtf_chunk_ranks<<<dim3(nc, B), kChunk, 0, st>>>(last, n, n_rows, N, group, lb_local, gpre,
                                                    used, ranks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// last: device uint8[N], N a multiple of 256, the first n bytes valid.
// scratch: device int32 of (nc + 2 * ng) * 256 entries, nc = N / 256 and
// ng = ceil(nc / group), 1 <= group <= 16. used: device bool[256]. ranks:
// device int32[N]. Launches the three kernels on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int tpubz_mtf_ranks(const void* last, int n, int N, int group, void* scratch,
                               void* used, void* ranks, void* stream) {
  if (N < 0 || N % kChunk || n < 0 || n > N || group < 1 || group > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return enqueue_mtf(static_cast<const uint8_t*>(last), n, nullptr, 1, N, group,
                     static_cast<int32_t*>(scratch), static_cast<uint8_t*>(used),
                     static_cast<int32_t*>(ranks), static_cast<cudaStream_t>(stream));
}

// The MTF of B rows at once: row b is last[b * N :], its first n_rows[b]
// bytes valid (n_rows: device int32[B], each in [0, N]); its ranks go to
// ranks[b * N :] and its used map to used[b * 256 :]. scratch: device int32
// of B * (nc + 2 * ng) * 256 entries. Each row equals tpubz_mtf_ranks of
// that row. Returns as tpubz_mtf_ranks.
extern "C" int tpubz_mtf_ranks_batch(const void* last, const void* n_rows, int B, int N,
                                     int group, void* scratch, void* used, void* ranks,
                                     void* stream) {
  if (N < 0 || N % kChunk || B < 1 || B > 65535 || group < 1 || group > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return enqueue_mtf(static_cast<const uint8_t*>(last), 0, static_cast<const int32_t*>(n_rows), B,
                     N, group, static_cast<int32_t*>(scratch), static_cast<uint8_t*>(used),
                     static_cast<int32_t*>(ranks), static_cast<cudaStream_t>(stream));
}

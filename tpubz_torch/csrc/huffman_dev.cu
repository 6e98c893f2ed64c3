// The device half of the Huffman refinement: the per-group histograms of a
// block's RLE2 symbols, and one refinement pass over the symbols themselves
// (each group's cheapest table, and each table's symbol frequencies over the
// groups that chose it), one kernel launched by one library call each.
//
// Replaces tpubz/kernels/huffman_dev.py:chunk_hist and chunk_hist_batch (a
// scatter-add of ones at (i // 50) * 258 + syms[i] for i < rle2_len) and
// refine_pass (two float32 matmuls on the MXU over that histogram, cost =
// hist . lens^T and rfreq = onehot(sel)^T . hist, with an argmin between
// them). Their outputs, bit for bit:
//   hist[g, s]  = #{i in [50g, 50g + 50) : i < rle2_len, syms[i] = s}, rows
//                 past the stream all zero;
//   sel[g]      = the t < table_count with the least
//                 cost[g, t] = sum over the group's symbols of lens[t, sym]
//                 (= hist[g] . lens[t]), ties to the lowest t (tpubz masks
//                 t >= table_count by adding 3e8 to the cost, so its stale
//                 rows of 15s never win; here they are left out by index),
//                 so a group with no symbol selects 0;
//   rfreq[t, s] = sum over g with sel[g] = t of hist[g, s].
// The costs are integer sums (at most 50 lengths each), so integer
// arithmetic gives tpubz's exact float sums, with no tensor core and no TF32.
//
//   chunk_hist_rows  one warp a group: its 258-bin row in shared memory,
//                    zeroed, at most 50 shared atomics, then the whole row
//                    stored with coalesced writes, zeros included, so the
//                    18.6 MB histogram of a level-9 block needs no memset.
//                    The row of a batch is grid dimension y.
//   refine_symbols   the pass without the histogram. The tables' lengths in
//                    shared memory, a byte each, two words a symbol (one
//                    8-byte load gives a symbol's six lengths; 16 bits
//                    each, a 16-byte load, was slower: ibwt_probe's
//                    refine_shapes). A warp takes
//                    16 groups at once (800 symbols, staged in shared memory
//                    with coalesced loads; consecutive tiles go to
//                    consecutive CTAs, and a tile past the stream only
//                    writes its selectors 0), two lanes a group, 25 symbols a
//                    lane: six integer costs a lane, one shuffle to add the
//                    pair's, a strict-< scan over t ascending; then each
//                    symbol is added to its group's table in the CTA's
//                    6 x 258 frequencies by one shared atomic (counting
//                    RUNA and RUNB, the hot bins, in registers instead was
//                    no faster: ibwt_probe's refine_shapes). The CTAs add
//                    their non-zero sums into a scratch of 1,548 words by
//                    integer atomics (exact in any order), and the last CTA
//                    by ticket moves them into rfreq and zeroes them, which
//                    leaves the scratch zeroed, and re-arms the ticket:
//                    one launch a pass and no memset (the scratch, 6,196
//                    bytes, is zeroed once when it is allocated).
//
// What bounds it on an H100: chunk_hist writes the histogram (18.58 MB at
// level 9: 18,003 groups x 258 x 4 bytes) and reads the symbols (1.80 MB of
// uint16), 6.1 us at 3.35 TB/s. refine_symbols reads the symbols once (2
// bytes a symbol, at most 1.8 MB at level 9: 0.54 us) and the 6 x 258
// lengths, and writes the selectors and frequencies; it does six gathers and
// adds a symbol and one shared atomic (6.3 M integer operations for 900,000
// symbols, 0.38 us at the int32 rate): bound by its bytes. The old
// formulation, a pass over the histogram, read 18.58 MB a pass (5.56 us).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 50;    // symbols a selector covers
constexpr int kAlpha = 258;   // a table's symbols
constexpr int kTables = 6;
constexpr int kHistWarps = 8;     // groups a CTA of chunk_hist_rows
constexpr int kRefineWarps = 16;  // warps a CTA of refine_symbols
constexpr int kRefineCtas = 132;  // at most: one a streaming multiprocessor
constexpr int kWarpGroups = 16;   // groups a warp takes at once, two lanes a group
constexpr int kLaneSyms = kGroup / 2;              // 25 symbols a lane
constexpr int kWarpSyms = kWarpGroups * kGroup;    // 800 symbols a warp's tile
constexpr int kSums = kTables * kAlpha;            // 1,548 frequencies
constexpr int kScratchWords = kSums + 1;           // the CTAs' sums, then the ticket
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

// One refinement pass over the symbols: each warp stages 16 groups' symbols
// (positions at or past the stream become kAlpha, a symbol of no length and
// no count), each lane pair costs one group, and each symbol counts once in
// the CTA's frequencies of its group's table. scratch: kScratchWords words,
// zero before the launch and zero again after it.
template <typename SymT>
__global__ void __launch_bounds__(kRefineWarps * 32)
    refine_symbols(const SymT* __restrict__ syms, const void* rle2_len, int len_bytes,
                   int out_len, int nsel, const int32_t* __restrict__ lens, int table_count,
                   int8_t* __restrict__ sel, int32_t* __restrict__ rfreq, int32_t* scratch) {
  __shared__ uint2 s_len[kAlpha + 1];  // symbol s: t0 | t1 << 8 | t2 << 16 | t3 << 24, t4 | t5 << 8
  __shared__ int s_rfreq[kSums];
  __shared__ uint16_t s_sym[kRefineWarps][kWarpSyms];
  __shared__ bool s_last;
  long long len = row_length(rle2_len, len_bytes, 0);
  if (len > out_len) len = out_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (nsel + kWarpGroups - 1) / kWarpGroups;
  const int stride = gridDim.x * kRefineWarps;
  // a tile's symbols in registers, lane-strided (coalesced loads)
  uint32_t fetched[kLaneSyms];
  auto fetch = [&](int tile) {
    const long long base = static_cast<long long>(tile) * kWarpSyms;
#pragma unroll
    for (int q = 0; q < kLaneSyms; ++q) {
      const long long i = base + q * 32 + lane;
      uint32_t s = kAlpha;
      if (i < len) {
        s = static_cast<uint32_t>(syms[i]);
        if (s > kAlpha) s = kAlpha;
      }
      fetched[q] = s;
    }
  };
  // consecutive tiles to consecutive CTAs: a short stream's tiles spread
  // over the streaming multiprocessors
  int tile = warp * gridDim.x + blockIdx.x;
  if (tile < tiles) fetch(tile);  // in flight while the lengths load
  for (int s = threadIdx.x; s <= kAlpha; s += blockDim.x) {
    uint32_t w[2] = {0, 0};
#pragma unroll
    for (int t = 0; t < kTables; ++t) {  // six loads in flight; tables past the count: none
      const uint32_t l = s < kAlpha && t < table_count ? lens[t * kAlpha + s] : 0;
      w[t >> 2] |= (l & 0xffu) << (8 * (t & 3));
    }
    s_len[s] = make_uint2(w[0], w[1]);
  }
  for (int k = threadIdx.x; k < kSums; k += blockDim.x) s_rfreq[k] = 0;
  __syncthreads();
  uint16_t* staged = s_sym[warp];
  const uint16_t* mine = staged + lane * kLaneSyms;  // group lane / 2, half lane % 2
  for (; tile < tiles; tile += stride) {
    if (static_cast<long long>(tile) * kWarpSyms >= len) {  // past the stream: no symbol, table 0
      const int g = tile * kWarpGroups + lane;
      if (lane < kWarpGroups && g < nsel) sel[g] = 0;
      if (tile + stride < tiles) fetch(tile + stride);
      continue;
    }
#pragma unroll
    for (int q = 0; q < kLaneSyms; ++q) staged[q * 32 + lane] = static_cast<uint16_t>(fetched[q]);
    __syncwarp();
    if (tile + stride < tiles) fetch(tile + stride);  // the next tile's, in flight meanwhile
    int c[kTables] = {0, 0, 0, 0, 0, 0};
#pragma unroll 5
    for (int q = 0; q < kLaneSyms; ++q) {
      const uint2 l = s_len[mine[q]];
      c[0] += l.x & 0xff;
      c[1] += (l.x >> 8) & 0xff;
      c[2] += (l.x >> 16) & 0xff;
      c[3] += l.x >> 24;
      c[4] += l.y & 0xff;
      c[5] += (l.y >> 8) & 0xff;
    }
    int best = 0;
#pragma unroll
    for (int t = 0; t < kTables; ++t) c[t] += __shfl_xor_sync(kFull, c[t], 1);
#pragma unroll
    for (int t = 1; t < kTables; ++t) {
      if (t < table_count && c[t] < c[best]) best = t;
    }
    const int g = tile * kWarpGroups + (lane >> 1);
    if ((lane & 1) == 0 && g < nsel) sel[g] = static_cast<int8_t>(best);
    int* f = s_rfreq + best * kAlpha;
#pragma unroll 5
    for (int q = 0; q < kLaneSyms; ++q) {
      const int s = mine[q];
      if (s < kAlpha) atomicAdd(f + s, 1);
    }
    __syncwarp();  // the tile's symbols are read before the next tile's land
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kSums; k += blockDim.x) {
    if (s_rfreq[k]) atomicAdd(scratch + k, s_rfreq[k]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(reinterpret_cast<unsigned*>(scratch + kSums), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // every CTA's sums are in the scratch before they are read
#pragma unroll 4
  for (int k = threadIdx.x; k < kSums; k += blockDim.x) {
    rfreq[k] = __ldcg(scratch + k);
    scratch[k] = 0;
  }
  if (threadIdx.x == 0) scratch[kSums] = 0;
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

// The words of refine_pass's scratch: device int32, zeroed once before the
// first call; each call leaves it zeroed for the next one on its stream.
extern "C" int tpubz_refine_scratch_words() { return kScratchWords; }

// syms: device symbols [out_len], int32 (sym_bytes 4) or uint16 (2), the
// first rle2_len (device int64 or int32, len_bytes 8 or 4) the stream; lens:
// device int32[6, 258], the first table_count rows each below 256; 1 <=
// table_count <= 6. sel: device int8[ceil(out_len / 50)]; rfreq: device
// int32[6, 258]; scratch: tpubz_refine_scratch_words() device words, zero.
// Launches the kernel on `stream` and returns cudaGetLastError() as an int.
extern "C" int tpubz_refine_pass(const void* syms, int sym_bytes, const void* rle2_len,
                                 int len_bytes, int out_len, const void* lens, int table_count,
                                 void* sel, void* rfreq, void* scratch, void* stream) {
  if (out_len < 1 || out_len >= (1 << 30) || table_count < 1 || table_count > kTables ||
      (sym_bytes != 4 && sym_bytes != 2) || (len_bytes != 8 && len_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int nsel = (out_len + kGroup - 1) / kGroup;
  const int tiles = (nsel + kWarpGroups - 1) / kWarpGroups;
  int ctas = (tiles + kRefineWarps - 1) / kRefineWarps;
  if (ctas > kRefineCtas) ctas = kRefineCtas;
  const auto* l = static_cast<const int32_t*>(lens);
  auto* s = static_cast<int8_t*>(sel);
  auto* f = static_cast<int32_t*>(rfreq);
  auto* w = static_cast<int32_t*>(scratch);
  if (sym_bytes == 4) {
    refine_symbols<<<ctas, kRefineWarps * 32, 0, st>>>(static_cast<const int32_t*>(syms),
                                                       rle2_len, len_bytes, out_len, nsel, l,
                                                       table_count, s, f, w);
  } else {
    refine_symbols<<<ctas, kRefineWarps * 32, 0, st>>>(static_cast<const uint16_t*>(syms),
                                                       rle2_len, len_bytes, out_len, nsel, l,
                                                       table_count, s, f, w);
  }
  return static_cast<int>(cudaGetLastError());
}

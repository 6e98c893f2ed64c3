// The passes of an LSD radix sort of int64 keys by a range of their bits,
// keys only, shared by csrc/radix.cu (the standalone sort) and csrc/bwt.cu
// (the sort of each doubling round, enqueued inside the BWT's call).
//
// Onesweep style: one launch histograms every digit of the keys (the
// caller's, since the BWT builds its keys in the same launch; hist_add and
// hist_flush below), then one launch a digit:
//   - each CTA takes a tile ticket from an atomic counter, so a tile's
//     predecessors are held by CTAs that already run (forward progress);
//   - it ranks its tile's keys by digit in shared memory, warp by warp:
//     __match_any_sync finds a key's peers, one lane adds their count to
//     the warp's counter, so equal digits keep their order (stable);
//   - it publishes its per-digit counts at once, then finds its global
//     offsets by decoupled look-back over the earlier tiles' status words
//     and publishes its inclusive sums;
//   - it writes each digit's run out through shared memory, so that the
//     stores of consecutive threads land on consecutive addresses.
// Status words carry a (round, pass) tag, so the caller zeroes them once per
// call (torch.empty scratch can hold an earlier call's words) and no pass
// or round needs them zeroed again.
//
// A launch sorts one or more rows, independent sorts side by side: grid
// dimension y walks a Rows list, and a CTA finds its row's keys, counts,
// tickets and status words at the row's offset from row 0's (the batched
// BWT keeps each row's scratch at a fixed stride). A standalone sort is
// one row at offset 0.
//
// What bounds a pass on an H100: each key is read once and written once,
// 16 bytes a key (14.4 MB at the BWT's 900,000 keys, 4.3 us at 3.35 TB/s;
// both buffers stay in the 50 MB L2). The look-back is a chain of L2 round
// trips per digit, which the early aggregates keep short.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"

namespace tpubz {
namespace radix {
// internal to each source that includes it: csrc/radix.cu and csrc/bwt.cu
// each compile their own copy of the kernels
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;  // keys a thread holds in a pass
constexpr int kTile = kThreads * kPer;
constexpr int kMaxLog2 = 20;
constexpr int kMaxPasses = 8;  // 63 bits in 8-bit digits
// The digit: 8 bits, five passes over the BWT's 40 sorted bits. Four 10-bit
// passes were slower on an H100 (a 10-bit pass ranks four times the digits
// with the same warps and shared memory; PERF.md section 6 keeps the times).
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr uint32_t kInvalid = 0xffffffffu;
constexpr unsigned kFull = 0xffffffffu;

// A status word: the count in bits 0-20 (at most 2^20 keys), the flag in
// bits 21-22, the (round, pass) tag in bits 23-31.
constexpr int kCountBits = 21;
constexpr uint32_t kCountMask = (1u << kCountBits) - 1;
constexpr uint32_t kAggregate = 1u << kCountBits;
constexpr uint32_t kInclusive = 2u << kCountBits;
constexpr uint32_t kFlagMask = 3u << kCountBits;
constexpr int kTagShift = 23;

// nonzero, below 2^9 for rounds < 63
__host__ __device__ constexpr uint32_t tag_of(int round, int pass) {
  return 1u + static_cast<uint32_t>(round * kMaxPasses + pass);
}

__host__ __device__ constexpr int passes_of(int lo, int hi) {
  return (hi - lo + kDigitBits - 1) / kDigitBits;
}

__host__ __device__ constexpr int tiles_of(int n) { return (n + kTile - 1) / kTile; }

__device__ __forceinline__ uint32_t digit_of(int64_t key, int shift, int width) {
  return static_cast<uint32_t>(static_cast<uint64_t>(key) >> shift) & ((1u << width) - 1);
}

// The rows a launch covers: blockIdx.y's row, its length, and the bytes
// between two rows' scratch (0 for one row).
constexpr int kMaxRows = 32;
struct Rows {
  int row[kMaxRows];
  int n[kMaxRows];
  long long stride;
};

inline Rows one_row(int n) {
  Rows r{};
  r.n[0] = n;
  return r;
}

// p moved to this CTA's row (null stays null)
template <typename T>
__device__ __forceinline__ T* at_row(T* p, const Rows& r) {
  if (p == nullptr) return p;
  return (T*)((char*)p + r.row[blockIdx.y] * r.stride);
}

// How many keys a launch sorts in a row. The BWT enqueues a round before
// the host knows that the round before was the last, and before any host
// knows how many rotations the round has: `done` (null, or a device int:
// nonzero and the launch has nothing to do) and `count` (null: the row's
// length; or the device int that holds it), row 0's, are read on the card
// at the CTA's row.
struct Gate {
  const int32_t* done;
  const int32_t* count;
};

__device__ __forceinline__ int gated_count(const Gate& g, const Rows& r) {
  const int32_t* done = at_row(g.done, r);
  const int32_t* count = at_row(g.count, r);
  if (done != nullptr && *done != 0) return 0;
  return count != nullptr ? *count : r.n[blockIdx.y];
}

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Adds key's digit of each pass over bits [lo, hi) to the CTA's counts,
// hist[pass << kDigitBits | digit]; lanes with equal digits add once. Every
// lane of the warp calls it; an invalid lane adds nothing.
__device__ __forceinline__ void hist_add(uint32_t* hist, int64_t key, bool valid, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  int p = 0;
  for (int shift = lo; shift < hi; shift += kDigitBits, ++p) {
    const uint32_t d = valid ? digit_of(key, shift, min(kDigitBits, hi - shift)) : kInvalid;
    const unsigned peers = __match_any_sync(kFull, d);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&hist[(p << kDigitBits) | d], __popc(peers));
  }
}

// The CTA's counts (passes << kDigitBits words, zero before the first
// hist_add) added to the sort's.
__device__ __forceinline__ void hist_flush(const uint32_t* s, uint32_t* hist, int passes) {
  __syncthreads();
  for (int x = threadIdx.x; x < passes << kDigitBits; x += blockDim.x) {
    if (s[x] != 0) atomicAdd(&hist[x], s[x]);
  }
}

// One pass: keys `in` to `out` by the digit (key >> shift) & (2^width - 1);
// every pointer is row 0's.
struct PassArgs {
  const int64_t* in;
  int64_t* out;
  int shift;
  int width;
  const uint32_t* hist;  // this pass's digit counts over all keys, kBins words
  uint32_t* status;      // kBins words per tile, this call's tags or zero
  uint32_t* ticket;      // this pass's tile counter, zero before the launch
  uint32_t tag;
  Gate gate;
};

union PassSmem {
  int64_t keys[kTile];         // the tile in output order
  uint16_t warp[kWarps][kBins];  // per warp and digit: its keys, then the warps' before
};

__global__ void __launch_bounds__(kThreads) radix_pass(PassArgs a, Rows rows) {
  constexpr int kBinsPer = kBins / kThreads;
  static_assert(kBinsPer >= 1 && kBins % kThreads == 0, "a thread owns whole digits");
  __shared__ PassSmem s;
  __shared__ int s_start[kBins];  // the digit's first index in the tile's output order
  __shared__ int s_delta[kBins];  // its global index less that
  __shared__ int s_tile;
  __shared__ int sh[32];
  const int m = gated_count(a.gate, rows);
  if (blockIdx.x >= tiles_of(m)) return;
  a.in = at_row(a.in, rows);
  a.out = at_row(a.out, rows);
  a.hist = at_row(a.hist, rows);
  a.status = at_row(a.status, rows);
  a.ticket = at_row(a.ticket, rows);
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(a.ticket, 1u));
  for (int x = threadIdx.x; x < kWarps * kBins; x += kThreads) (&s.warp[0][0])[x] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile;
  const int count = min(kTile, m - base);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;

  // warp w holds tile indices [w * 32 * kPer, (w + 1) * 32 * kPer), the
  // lanes side by side, and ranks them in index order
  int64_t key[kPer];
  int pos[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int x = (w * kPer + j) * 32 + lane;
    key[j] = x < count ? a.in[base + x] : 0;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool valid = (w * kPer + j) * 32 + lane < count;
    const uint32_t d = valid ? digit_of(key[j], a.shift, a.width) : kInvalid;
    const unsigned peers = __match_any_sync(kFull, d);
    const int prior = valid ? s.warp[w][d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) s.warp[w][d] = static_cast<uint16_t>(prior + __popc(peers));
    __syncwarp();
    pos[j] = prior + __popc(peers & below);
  }
  __syncthreads();

  // per digit this thread owns: the earlier warps' counts, in place, and
  // the tile's total, published at once for the tiles that look back
  int total[kBinsPer];
#pragma unroll
  for (int i = 0; i < kBinsPer; ++i) {
    const int b = threadIdx.x * kBinsPer + i;
    int run = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int c = s.warp[v][b];
      s.warp[v][b] = static_cast<uint16_t>(run);
      run += c;
    }
    total[i] = run;
    st_relaxed(&a.status[tile * kBins + b],
               (a.tag << kTagShift) | (tile == 0 ? kInclusive : kAggregate) | run);
  }
  // decoupled look-back: add up the earlier tiles' counts of the digit,
  // back to the first inclusive sum
  int before[kBinsPer];
#pragma unroll
  for (int i = 0; i < kBinsPer; ++i) {
    const int b = threadIdx.x * kBinsPer + i;
    int excl = 0;
    for (int t = tile - 1; t >= 0;) {
      const uint32_t word = ld_relaxed(&a.status[t * kBins + b]);
      if ((word >> kTagShift) != a.tag || (word & kFlagMask) == 0) continue;  // not yet
      excl += static_cast<int>(word & kCountMask);
      if ((word & kFlagMask) == kInclusive) break;
      --t;
    }
    if (tile > 0) {
      st_relaxed(&a.status[tile * kBins + b], (a.tag << kTagShift) | kInclusive | (excl + total[i]));
    }
    before[i] = excl;
  }
  // where each digit starts: among all keys (the scan of the histogram)
  // and in this tile's output order
  int hsum = 0, tsum = 0;
#pragma unroll
  for (int i = 0; i < kBinsPer; ++i) {
    hsum += static_cast<int>(a.hist[threadIdx.x * kBinsPer + i]);
    tsum += total[i];
  }
  int unused;
  int hrun = tpubz::block_exclusive(hsum, 0, tpubz::Sum(), sh, &unused);
  int trun = tpubz::block_exclusive(tsum, 0, tpubz::Sum(), sh, &unused);
#pragma unroll
  for (int i = 0; i < kBinsPer; ++i) {
    const int b = threadIdx.x * kBinsPer + i;
    s_start[b] = trun;
    s_delta[b] = hrun + before[i] - trun;
    hrun += static_cast<int>(a.hist[b]);
    trun += total[i];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((w * kPer + j) * 32 + lane < count) {
      const uint32_t d = digit_of(key[j], a.shift, a.width);
      pos[j] += s_start[d] + s.warp[w][d];
    }
  }
  __syncthreads();  // the counters are read: the keys may take their place
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((w * kPer + j) * 32 + lane < count) s.keys[pos[j]] = key[j];
  }
  __syncthreads();
  for (int x = threadIdx.x; x < count; x += kThreads) {
    const int64_t k = s.keys[x];
    a.out[x + s_delta[digit_of(k, a.shift, a.width)]] = k;
  }
}

// Enqueues the passes of one sort by bits [lo, hi): pass p reads `in`
// (p = 0) or the pass before's output and writes bufs[(passes - 1 - p) & 1],
// so the last pass writes bufs[0]; `in` may be bufs[passes & 1]. hist: the
// histogram launch's counts, pass p's at hist + (p << kDigitBits); tickets:
// one zeroed word a pass. All of them are row 0's. Grid: tiles of the most
// keys the gate can let through in any row, by `count` rows. Adds its
// launches to *launched.
int enqueue_passes(const int64_t* in, int64_t* const bufs[2], int lo, int hi,
                   const uint32_t* hist, uint32_t* status, uint32_t* tickets, int round, Gate gate,
                   const Rows& rows, int count, int grid, int* launched, cudaStream_t st) {
  const int passes = passes_of(lo, hi);
  for (int p = 0; p < passes; ++p) {
    const int shift = lo + p * kDigitBits;
    PassArgs a{p == 0 ? in : bufs[(passes - p) & 1],
               bufs[(passes - 1 - p) & 1],
               shift,
               hi - shift < kDigitBits ? hi - shift : kDigitBits,
               hist + (p << kDigitBits),
               status,
               tickets + p,
               tag_of(round, p),
               gate};
    radix_pass<<<dim3(grid, count), kThreads, 0, st>>>(a, rows);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    ++*launched;
  }
  return 0;
}

}  // namespace
}  // namespace radix
}  // namespace tpubz

// The passes of an LSD radix sort of int64 keys by a range of their bits,
// keys only, shared by csrc/radix.cu (the standalone sort) and csrc/bwt.cu
// (the sort of each doubling round, enqueued inside the BWT's call).
//
// Onesweep style: one launch histograms every digit of the keys (the
// caller's, since the BWT builds its keys in the same launch; hist_add and
// hist_flush below, one shared atomic a key and digit), then one launch a
// digit (onesweep_pass; radix_pass when the host knows the arguments, the
// BWT's own kernel when a device word holds them):
//   - each CTA takes a tile ticket from an atomic counter, so a tile's
//     predecessors are held by CTAs that already run (forward progress);
//   - it ranks its tile's keys by digit in shared memory, warp by warp:
//     __match_any_sync finds a key's peers (digit_peers), one lane adds
//     their count to the warp's counter, so equal digits keep their order
//     (stable);
//   - it publishes its per-digit counts at once, then finds its global
//     offsets by decoupled look-back over the earlier tiles' status words
//     and publishes its inclusive sums;
//   - it writes each digit's run out through shared memory, so that the
//     stores of consecutive threads land on consecutive addresses.
// Status words carry a (round, pass) tag, so the caller zeroes them once per
// call (torch.empty scratch can hold an earlier call's words) and no pass
// or round needs them zeroed again.
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
constexpr unsigned kFull = 0xffffffffu;

// A status word: the count in bits 0-20 (at most 2^20 keys), the flag in
// bits 21-22, the (round, pass) tag in bits 23-31.
constexpr int kCountBits = 21;
constexpr uint32_t kCountMask = (1u << kCountBits) - 1;
constexpr uint32_t kAggregate = 1u << kCountBits;
constexpr uint32_t kInclusive = 2u << kCountBits;
constexpr uint32_t kFlagMask = 3u << kCountBits;
constexpr int kTagShift = 23;
constexpr int kLookBack = 8;  // status words a look-back step reads at once

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

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The lanes of the warp whose digit equals this lane's, among the lanes
// where `valid` holds (an invalid lane's own set is the invalid lanes).
// __match_any_sync: the ballot a digit bit that the onesweep match of CUB
// uses was slower on an H100 (PERF.md section 6; bwt_probe's ballot variant), the shared
// atomics of hist_add are not ordered, and the ranks must keep the order of
// equal digits.
__device__ __forceinline__ unsigned digit_peers(uint32_t d, bool valid) {
  return __match_any_sync(kFull, valid ? d : 0xffffffffu);
}

// Adds key's digit of each pass over bits [lo, hi) to the CTA's counts,
// hist[pass << kDigitBits | digit]: one shared atomic a key and digit (the
// counts need no order). An invalid key adds nothing.
__device__ __forceinline__ void hist_add(uint32_t* hist, int64_t key, bool valid, int lo, int hi) {
  if (!valid) return;
  int p = 0;
  for (int shift = lo; shift < hi; shift += kDigitBits, ++p) {
    atomicAdd(&hist[(p << kDigitBits) | digit_of(key, shift, min(kDigitBits, hi - shift))], 1u);
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

// One pass of m keys: `in` to `out` by the digit (key >> shift) &
// (2^width - 1).
struct PassArgs {
  const int64_t* in;
  int64_t* out;
  int shift;
  int width;
  const uint32_t* hist;  // this pass's digit counts over all keys, kBins words
  uint32_t* status;      // kBins words per tile, this call's tags or zero
  uint32_t* ticket;      // this pass's tile counter, zero before the launch
  uint32_t tag;
  int m;
};

union PassSmem {
  int64_t keys[kTile];           // the tile in output order
  uint16_t warp[kWarps][kBins];  // per warp and digit: its keys, then the warps' before
};

// The body of a pass over m keys: the CTA's tile by ticket, its keys
// ranked warp by warp, the counts published and looked back on, the keys
// written out through shared memory. Called by every thread of a CTA of
// kThreads with a tile to sort (blockIdx.x < tiles_of(m)).
__device__ __forceinline__ void onesweep_pass(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                                              int shift, int width, const uint32_t* hist,
                                              uint32_t* status, uint32_t* ticket, uint32_t tag,
                                              int m) {
  constexpr int kBinsPer = kBins / kThreads;
  static_assert(kBinsPer >= 1 && kBins % kThreads == 0, "a thread owns whole digits");
  __shared__ PassSmem s;
  __shared__ int s_start[kBins];  // the digit's first index in the tile's output order
  __shared__ int s_delta[kBins];  // its global index less that
  __shared__ int s_tile;
  __shared__ int sh[32];
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u));
  for (int x = threadIdx.x; x < kWarps * kBins; x += kThreads) (&s.warp[0][0])[x] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile;
  const int count = min(kTile, m - base);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;

  // warp w holds tile indices [w * 32 * kPer, (w + 1) * 32 * kPer), the
  // lanes side by side, and ranks them in index order: the lowest lane of
  // each set of equal digits advances the warp's counter
  int64_t key[kPer];
  int pos[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int x = (w * kPer + j) * 32 + lane;
    key[j] = x < count ? in[base + x] : 0;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool valid = (w * kPer + j) * 32 + lane < count;
    const uint32_t d = digit_of(key[j], shift, width);
    const unsigned peers = digit_peers(d, valid);
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
    st_relaxed(&status[tile * kBins + b], (tag << kTagShift) | (tile == 0 ? kInclusive : kAggregate) | run);
  }
  // decoupled look-back: add up the earlier tiles' counts of the digit,
  // back to the first inclusive sum, kLookBack words read at once (a tile
  // not yet published is read again, from it on)
  int before[kBinsPer];
#pragma unroll
  for (int i = 0; i < kBinsPer; ++i) {
    const int b = threadIdx.x * kBinsPer + i;
    int excl = 0;
    for (int t = tile - 1; t >= 0;) {
      uint32_t word[kLookBack];
#pragma unroll
      for (int k = 0; k < kLookBack; ++k) word[k] = t - k >= 0 ? ld_relaxed(&status[(t - k) * kBins + b]) : 0;
      int k = 0;
      for (; k < kLookBack && t - k >= 0; ++k) {
        if ((word[k] >> kTagShift) != tag || (word[k] & kFlagMask) == 0) break;  // not yet
        excl += static_cast<int>(word[k] & kCountMask);
        if ((word[k] & kFlagMask) == kInclusive) break;
      }
      if (k < kLookBack && t - k >= 0 && (word[k] & kFlagMask) == kInclusive &&
          (word[k] >> kTagShift) == tag) {
        break;  // the inclusive sum ended it
      }
      t -= k;  // from the first word not yet published, or past the batch
    }
    if (tile > 0) {
      st_relaxed(&status[tile * kBins + b], (tag << kTagShift) | kInclusive | (excl + total[i]));
    }
    before[i] = excl;
  }
  // where each digit starts: among all keys (the scan of the histogram)
  // and in this tile's output order
  int hsum = 0, tsum = 0;
#pragma unroll
  for (int i = 0; i < kBinsPer; ++i) {
    hsum += static_cast<int>(hist[threadIdx.x * kBinsPer + i]);
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
    hrun += static_cast<int>(hist[b]);
    trun += total[i];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((w * kPer + j) * 32 + lane < count) {
      const uint32_t d = digit_of(key[j], shift, width);
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
    out[x + s_delta[digit_of(k, shift, width)]] = k;
  }
}

// A pass of a sort whose arguments the host knows (the standalone sort and
// the inverse BWT's next pointers).
__global__ void __launch_bounds__(kThreads) radix_pass(PassArgs a) {
  if (blockIdx.x >= tiles_of(a.m)) return;
  onesweep_pass(a.in, a.out, a.shift, a.width, a.hist, a.status, a.ticket, a.tag, a.m);
}

// Enqueues the passes of one sort of n keys by bits [lo, hi): pass p reads
// `in` (p = 0) or the pass before's output and writes bufs[(passes - 1 -
// p) & 1], so the last pass writes bufs[0]; `in` may be bufs[passes & 1].
// hist: the histogram launch's counts, pass p's at hist + (p << kDigitBits);
// tickets: one zeroed word a pass. Adds its launches to *launched.
int enqueue_passes(const int64_t* in, int64_t* const bufs[2], int n, int lo, int hi,
                   const uint32_t* hist, uint32_t* status, uint32_t* tickets, int* launched,
                   cudaStream_t st) {
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
               tag_of(0, p),
               n};
    radix_pass<<<tiles_of(n), kThreads, 0, st>>>(a);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    ++*launched;
  }
  return 0;
}

}  // namespace
}  // namespace radix
}  // namespace tpubz

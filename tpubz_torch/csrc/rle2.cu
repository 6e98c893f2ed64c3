// RLE2 zero-run coding of MTF ranks on the card: symbols, length and
// frequencies in three kernels, launched by one library call.
//
// Replaces tpubz/kernels/rle2.py:rle2_encode, an XLA kernel of tpubz's
// device chain (a prefix max, a suffix min, an exclusive cumsum, one
// unique-index scatter and a 258-bin histogram). Its outputs, bit for bit:
// a zero run of length L becomes the floor(log2(L+1)) bijective base-2
// digits of L (RUNA=0, RUNB=1, low digit first: digit k = ((L+1) >> k) & 1),
// a rank r >= 1 becomes symbol r+1, the EOB goes at rle2_len-1, slots from
// rle2_len on are 0, and freqs counts syms[:rle2_len].
//
// A zero run can cross any number of tiles, so a tile's output offset
// depends on the last nonzero before it. The literal that closes a run
// writes the run's digits; the trailing run's digits go last.
//   rle2_tile_stats  one CTA per tile of 4096 ranks (16 a thread): the
//                    tile's first and last nonzero and its emit count
//                    without the digits of the run before its first
//                    nonzero (block scans of the threads' last nonzero and
//                    emit counts).
//   rle2_scan        one CTA scans the tiles' (last nonzero, emit count)
//                    in rounds of 1024 with a carry: each tile's previous
//                    nonzero and output offset, rle2_len, the trailing
//                    digits and the EOB; it zeroes freqs and counts those.
//   rle2_write       one CTA per tile: the same per-thread scans from the
//                    tile's carry, then each nonzero writes its run's digits
//                    and its literal at its offset, the CTA zeroes its share
//                    of the slots past rle2_len, and a shared 258-bin
//                    histogram (warp-aggregated) goes to freqs by integer
//                    atomics, exact in any order.
//
// What bounds it on an H100: 4N bytes of ranks in and 4(N+8) of symbols out
// (7.2 MB at level 9, 2.15 us at 3.35 TB/s); the ranks are read twice, the
// second time mostly from the 50 MB L2. The work per rank is a few integer
// instructions and two block scans per tile, so the kernels are bound by
// memory and launch latency, not by issue.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "block_scan.cuh"

namespace {

using tpubz::block_exclusive;
using tpubz::Max;
using tpubz::Min;
using tpubz::Sum;

constexpr int kThreads = 256;
constexpr int kPer = 16;  // ranks a thread holds
constexpr int kTile = kThreads * kPer;
constexpr int kScanThreads = 1024;
constexpr int kBins = 258;
constexpr unsigned kFull = 0xffffffffu;

// floor(log2(L+1)) digits for a run of L zeros; none for L <= 0
__device__ __forceinline__ int num_digits(int run) {
  return run > 0 ? 31 - __clz(run + 1) : 0;
}

// this thread's 16 ranks; positions at or past N read as 0
__device__ __forceinline__ void load_ranks(const int32_t* ranks, int base, int N, int (&r)[kPer]) {
  if (base + kPer <= N) {
    const int4* v = reinterpret_cast<const int4*>(ranks + base);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int4 x = v[q];
      r[4 * q] = x.x;
      r[4 * q + 1] = x.y;
      r[4 * q + 2] = x.z;
      r[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) r[k] = base + k < N ? ranks[base + k] : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    rle2_tile_stats(const int32_t* __restrict__ ranks, int n, int N, int4* __restrict__ stats) {
  __shared__ int sh[32];
  const int base = blockIdx.x * kTile + threadIdx.x * kPer;
  int r[kPer];
  load_ranks(ranks, base, N, r);
  int first = INT_MAX, last = -1;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (base + k < n && r[k] != 0) {
      first = min(first, base + k);
      last = base + k;
    }
  }
  int tile_last, tile_first, tile_emit;
  // the previous nonzero in the tile; -1 before the tile's first, whose
  // run is counted by the scan once the tiles before are known
  int prev = block_exclusive(last, -1, Max(), sh, &tile_last);
  block_exclusive(first, INT_MAX, Min(), sh, &tile_first);
  int emit = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + k;
    if (i < n && r[k] != 0) {
      emit += (prev >= 0 ? num_digits(i - prev - 1) : 0) + 1;
      prev = i;
    }
  }
  block_exclusive(emit, 0, Sum(), sh, &tile_emit);
  if (threadIdx.x == 0) stats[blockIdx.x] = make_int4(tile_first, tile_last, tile_emit, 0);
}

__global__ void __launch_bounds__(kScanThreads)
    rle2_scan(const int4* __restrict__ stats, int nb, int n, const int64_t* __restrict__ eob,
              int out_len, int2* __restrict__ carry, int32_t* __restrict__ syms,
              int64_t* __restrict__ rle2_len, int64_t* __restrict__ freqs) {
  __shared__ int sh[32];
  int last_nz = -1, body = 0;  // carried across rounds
  for (int b0 = 0; b0 < nb; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const int4 st = b < nb ? stats[b] : make_int4(INT_MAX, -1, 0, 0);
    int round_last, round_emit;
    const int prev = max(block_exclusive(st.y, -1, Max(), sh, &round_last), last_nz);
    // a tile with a nonzero also writes the digits of the run before it
    const int emit = st.y >= 0 ? st.z + num_digits(st.x - prev - 1) : 0;
    const int off = block_exclusive(emit, 0, Sum(), sh, &round_emit) + body;
    if (b < nb) carry[b] = make_int2(prev, off);
    last_nz = max(last_nz, round_last);
    body += round_emit;
  }
  const int tail = n - 1 - last_nz;  // the run after the last nonzero
  const int tail_digits = num_digits(tail);
  const int len = body + tail_digits + 1;
  const int end = static_cast<int>(*eob);
  for (int s = threadIdx.x; s < kBins; s += blockDim.x) {
    int64_t f = s == end;
    for (int k = 0; k < tail_digits; ++k) f += (((tail + 1) >> k) & 1) == s;
    freqs[s] = f;
  }
  if (threadIdx.x < tail_digits) syms[body + threadIdx.x] = ((tail + 1) >> threadIdx.x) & 1;
  // the slots past the stream and past every tile (the tiles zero theirs)
  for (int j = max(len, nb * kTile) + threadIdx.x; j < out_len; j += blockDim.x) syms[j] = 0;
  if (threadIdx.x == 0) {
    syms[len - 1] = end;
    *rle2_len = len;
  }
}

__global__ void __launch_bounds__(kThreads)
    rle2_write(const int32_t* __restrict__ ranks, int n, int N, const int2* __restrict__ carry,
               const int64_t* __restrict__ rle2_len, int out_len, int32_t* __restrict__ syms,
               int64_t* __restrict__ freqs) {
  __shared__ int sh[32];
  __shared__ int hist[kBins];
  const int t = threadIdx.x, lane = t & 31;
  for (int s = t; s < kBins; s += kThreads) hist[s] = 0;
  const int base = blockIdx.x * kTile + t * kPer;
  int r[kPer];
  load_ranks(ranks, base, N, r);
  int last = -1;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (base + k < n && r[k] != 0) last = base + k;
  }
  const int2 cr = carry[blockIdx.x];
  int unused;
  const int prev = max(block_exclusive(last, -1, Max(), sh, &unused), cr.x);
  int emit = 0;
  int p = prev;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + k;
    if (i < n && r[k] != 0) {
      emit += num_digits(i - p - 1) + 1;
      p = i;
    }
  }
  int off = block_exclusive(emit, 0, Sum(), sh, &unused) + cr.y;
  int runb = 0, runa = 0;
  p = prev;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + k;
    const bool nz = i < n && r[k] != 0;
    if (nz) {
      const int run = i - p - 1;
      const int d = num_digits(run);
      for (int q = 0; q < d; ++q) {
        const int digit = ((run + 1) >> q) & 1;
        syms[off + q] = digit;
        runb += digit;
      }
      runa += d;
      syms[off + d] = r[k] + 1;
      off += d + 1;
      p = i;
    }
    // the literals of the warp's k-th ranks, one shared atomic per value
    const int lit = nz ? r[k] + 1 : -1;
    const unsigned peers = __match_any_sync(kFull, lit);
    if (lit >= 0 && lit < kBins && __ffs(peers) - 1 == lane) atomicAdd(&hist[lit], __popc(peers));
  }
  runa -= runb;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    runa += __shfl_down_sync(kFull, runa, d);
    runb += __shfl_down_sync(kFull, runb, d);
  }
  if (lane == 0) {
    if (runa) atomicAdd(&hist[0], runa);
    if (runb) atomicAdd(&hist[1], runb);
  }
  // this CTA's share of the slots past the stream
  const int len = static_cast<int>(*rle2_len);
  const int z1 = min(static_cast<int>(blockIdx.x + 1) * kTile, out_len);
  for (int j = max(static_cast<int>(blockIdx.x) * kTile, len) + t; j < z1; j += kThreads) syms[j] = 0;
  __syncthreads();
  for (int s = t; s < kBins; s += kThreads) {
    if (hist[s]) {
      atomicAdd(reinterpret_cast<unsigned long long*>(freqs + s),
                static_cast<unsigned long long>(hist[s]));
    }
  }
}

}  // namespace

// ranks: device int32[N], 16-byte aligned, the first n valid. eob: device
// int64 scalar. scratch: device int32 of 6 * nb entries, nb = ceil(N / 4096).
// syms: device int32[N + 8]; rle2_len: device int64 scalar; freqs: device
// int64[258]. Launches the three kernels on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int tpubz_rle2(const void* ranks, int n, int N, const void* eob, void* scratch,
                          int nb, void* syms, void* rle2_len, void* freqs, void* stream) {
  if (N < 0 || n < 0 || n > N || nb != (N + kTile - 1) / kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* stats = static_cast<int4*>(scratch);
  auto* carry = reinterpret_cast<int2*>(static_cast<int32_t*>(scratch) + 4 * static_cast<size_t>(nb));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(ranks);
  auto* out = static_cast<int32_t*>(syms);
  auto* len = static_cast<int64_t*>(rle2_len);
  auto* f = static_cast<int64_t*>(freqs);
  if (nb > 0) {
    rle2_tile_stats<<<nb, kThreads, 0, st>>>(r, n, N, stats);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  rle2_scan<<<1, kScanThreads, 0, st>>>(stats, nb, n, static_cast<const int64_t*>(eob), N + 8,
                                        carry, out, len, f);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (nb > 0) rle2_write<<<nb, kThreads, 0, st>>>(r, n, N, carry, len, N + 8, out, f);
  return static_cast<int>(cudaGetLastError());
}

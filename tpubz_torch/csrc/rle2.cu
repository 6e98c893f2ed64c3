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
// The batched call (tpubz_rle2_batch, the counterpart of
// tpubz/kernels/rle2.py:rle2_encode_batch) runs the same three kernels with
// the row as grid dimension y (one scan CTA a row): each row has its own
// ranks, length, EOB, tile statistics and outputs, and no offset crosses a
// row. It writes tpubz's batch types (uint16 symbols, int32 length and
// frequencies); the one-block call keeps int32 symbols and int64 length and
// frequencies. The types are template parameters of the kernels.
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

// The length of the CTA's row: n_rows[row] where the call has a device
// array of them, else n.
__device__ __forceinline__ int row_length(int n, const int32_t* n_rows) {
  return n_rows != nullptr ? n_rows[blockIdx.y] : n;
}

// count += v for a frequency slot of either width, exact in any order
__device__ __forceinline__ void add_count(int64_t* f, int v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(f), static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void add_count(int32_t* f, int v) { atomicAdd(f, v); }

__global__ void __launch_bounds__(kThreads)
    rle2_tile_stats(const int32_t* __restrict__ ranks, int n, const int32_t* __restrict__ n_rows,
                    int N, int4* __restrict__ stats) {
  __shared__ int sh[32];
  const size_t row = blockIdx.y;
  n = row_length(n, n_rows);
  ranks += row * N;
  stats += row * gridDim.x;
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

// One CTA a row (blockIdx.y), eob[row] its EOB.
template <typename E, typename S, typename L, typename F>
__global__ void __launch_bounds__(kScanThreads)
    rle2_scan(const int4* __restrict__ stats, int nb, int n, const int32_t* __restrict__ n_rows,
              const E* __restrict__ eob, int out_len, int2* __restrict__ carry,
              S* __restrict__ syms, L* __restrict__ rle2_len, F* __restrict__ freqs) {
  __shared__ int sh[32];
  const size_t row = blockIdx.y;
  n = row_length(n, n_rows);
  stats += row * nb;
  carry += row * nb;
  syms += row * out_len;
  freqs += row * kBins;
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
  const int end = static_cast<int>(eob[row]);
  for (int s = threadIdx.x; s < kBins; s += blockDim.x) {
    int f = s == end;
    for (int k = 0; k < tail_digits; ++k) f += (((tail + 1) >> k) & 1) == s;
    freqs[s] = static_cast<F>(f);
  }
  if (threadIdx.x < tail_digits) {
    syms[body + threadIdx.x] = static_cast<S>(((tail + 1) >> threadIdx.x) & 1);
  }
  // the slots past the stream and past every tile (the tiles zero theirs)
  for (int j = max(len, nb * kTile) + threadIdx.x; j < out_len; j += blockDim.x) syms[j] = 0;
  if (threadIdx.x == 0) {
    syms[len - 1] = static_cast<S>(end);
    rle2_len[row] = static_cast<L>(len);
  }
}

template <typename S, typename L, typename F>
__global__ void __launch_bounds__(kThreads)
    rle2_write(const int32_t* __restrict__ ranks, int n, const int32_t* __restrict__ n_rows, int N,
               const int2* __restrict__ carry, const L* __restrict__ rle2_len, int out_len,
               S* __restrict__ syms, F* __restrict__ freqs) {
  __shared__ int sh[32];
  __shared__ int hist[kBins];
  const size_t row = blockIdx.y;
  n = row_length(n, n_rows);
  ranks += row * N;
  carry += row * gridDim.x;
  syms += row * out_len;
  freqs += row * kBins;
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
        syms[off + q] = static_cast<S>(digit);
        runb += digit;
      }
      runa += d;
      syms[off + d] = static_cast<S>(r[k] + 1);
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
  const int len = static_cast<int>(rle2_len[row]);
  const int z1 = min(static_cast<int>(blockIdx.x + 1) * kTile, out_len);
  for (int j = max(static_cast<int>(blockIdx.x) * kTile, len) + t; j < z1; j += kThreads) syms[j] = 0;
  __syncthreads();
  for (int s = t; s < kBins; s += kThreads) {
    if (hist[s]) add_count(freqs + s, hist[s]);
  }
}

// The three launches over B rows of N ranks; row b's length is n_rows[b]
// (device) where n_rows is given, else n; its EOB is eob[b].
template <typename E, typename S, typename L, typename F>
int enqueue_rle2(const int32_t* ranks, int n, const int32_t* n_rows, int B, int N, const E* eob,
                 void* scratch, int nb, S* syms, L* rle2_len, F* freqs, cudaStream_t st) {
  auto* stats = static_cast<int4*>(scratch);
  auto* carry = reinterpret_cast<int2*>(stats + static_cast<size_t>(B) * nb);
  if (nb > 0) {
    rle2_tile_stats<<<dim3(nb, B), kThreads, 0, st>>>(ranks, n, n_rows, N, stats);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  rle2_scan<<<dim3(1, B), kScanThreads, 0, st>>>(stats, nb, n, n_rows, eob, N + 8, carry, syms,
                                                  rle2_len, freqs);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (nb > 0) {
    rle2_write<<<dim3(nb, B), kThreads, 0, st>>>(ranks, n, n_rows, N, carry, rle2_len, N + 8,
                                                  syms, freqs);
  }
  return static_cast<int>(cudaGetLastError());
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
  return enqueue_rle2(static_cast<const int32_t*>(ranks), n, nullptr, 1, N,
                      static_cast<const int64_t*>(eob), scratch, nb, static_cast<int32_t*>(syms),
                      static_cast<int64_t*>(rle2_len), static_cast<int64_t*>(freqs),
                      static_cast<cudaStream_t>(stream));
}

// RLE2 of B rows at once: row b's ranks at ranks[b * N :] (N a multiple of
// 4, 16-byte aligned), its first n_rows[b] valid (device int32[B]), its EOB
// eob[b] (device int32[B]). scratch: device int32 of 6 * B * nb entries.
// syms: device uint16[B, N + 8]; rle2_len: device int32[B]; freqs: device
// int32[B, 258]. Each row equals tpubz_rle2 of that row. Returns as
// tpubz_rle2.
extern "C" int tpubz_rle2_batch(const void* ranks, const void* n_rows, int B, int N,
                                const void* eob, void* scratch, int nb, void* syms,
                                void* rle2_len, void* freqs, void* stream) {
  if (N < 0 || N % 4 || B < 1 || B > 65535 || nb != (N + kTile - 1) / kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return enqueue_rle2(static_cast<const int32_t*>(ranks), 0, static_cast<const int32_t*>(n_rows),
                      B, N, static_cast<const int32_t*>(eob), scratch, nb,
                      static_cast<uint16_t*>(syms), static_cast<int32_t*>(rle2_len),
                      static_cast<int32_t*>(freqs), static_cast<cudaStream_t>(stream));
}

// The inverse BWT on the card: the next-pointer vector by a stable counting
// sort, and the key's orbit by pointer doubling, each one library call.
//
// Replaces tpubz/kernels/ibwt.py:_next_pointers (a stable (byte, position)
// sort of the last column, lanes >= n as byte 256) and bwt_inverse_device
// (the orbit of the key in ceil(log2 n) doubling steps, each a jit call of
// its own driven from the host). Its outputs, bit for bit: nxt[j] = the
// position in `last` of the j-th entry in (byte, position) order, so
// nxt[n:] = n..N-1; the inverse out[i] = last[jump^(i+1)(key)], jump = nxt.
//
//   ibwt_keys     one CTA per tile of 4096 positions: key (byte << 20) | i
//                 of each position below n, and the CTA's byte counts added
//                 to the sort's histogram (csrc/radix.cuh hist_add).
//   radix_pass    csrc/radix.cuh's onesweep pass over bits [20, 28): one
//                 8-bit digit, stable, so equal bytes keep position order.
//   ibwt_nxt      nxt[j] = the low 20 bits of sorted key j below n, j above.
// The inverse's call runs those three, then per doubling round k = 1, 2,
// 4, ... one launch of ibwt_round: positions[k + i] = jump[positions[i]]
// and out[k + i] = last[that] for i < min(k, n - k), and, unless it is the
// last round, jump2[j] = jump[jump[j]] for j < n into the other buffer
// (never in place: other threads still read jump). The host knows the
// round count from n, so every round is enqueued back to back, with no
// host round trip, where tpubz pays one jit dispatch a round.
//
// What bounds it on an H100: the next pointers read n bytes and write 4N
// (1.3 us at level 9 at 3.35 TB/s); the sort moves 16 bytes a key a pass
// through the 50 MB L2. Any inverse reads n bytes and writes n (0.54 us);
// this formulation's rounds read and write the 3.6 MB pointer array each
// (20 rounds at level 9, ~70 us of HBM bytes), but the arrays fit in the
// L2, so the rounds are bound by random 4-byte gathers through it.
#include <cuda_runtime.h>

#include <cstdint>

#include "radix.cuh"

namespace tpubz {
namespace radix {
namespace {  // the header's: one internal namespace in this source

constexpr int kPosBits = 20;  // a position below 2^20 (radix.cuh's kMaxLog2)
constexpr int kRoundThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ibwt_keys(const uint8_t* __restrict__ last, int n, int64_t* __restrict__ keys,
              uint32_t* hist) {
  __shared__ uint32_t s_hist[kBins];
  for (int x = threadIdx.x; x < kBins; x += kThreads) s_hist[x] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
#pragma unroll 4
  for (int j = 0; j < kPer; ++j) {
    const int q = base + j * kThreads + threadIdx.x;
    const bool valid = q < n;
    const int64_t key = valid ? (static_cast<int64_t>(last[q]) << kPosBits) | q : 0;
    if (valid) keys[q] = key;
    hist_add(s_hist, key, valid, kPosBits, kPosBits + kDigitBits);
  }
  hist_flush(s_hist, hist, 1);
}

__global__ void ibwt_nxt(const int64_t* __restrict__ sorted, int n, int N,
                         int32_t* __restrict__ nxt) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < N) nxt[j] = j < n ? static_cast<int32_t>(sorted[j] & ((1 << kPosBits) - 1)) : j;
}

__global__ void ibwt_seed(const int32_t* __restrict__ nxt, int key, const uint8_t* __restrict__ last,
                          int32_t* __restrict__ positions, uint8_t* __restrict__ out) {
  const int p = nxt[key];
  positions[0] = p;
  out[0] = last[p];
}

// One doubling round from `filled` known positions: take of them extended,
// and jump squared into jump2 where jump2 is not null.
__global__ void __launch_bounds__(kRoundThreads)
    ibwt_round(const int32_t* __restrict__ jump, int32_t* __restrict__ jump2, int n, int filled,
               int take, const uint8_t* __restrict__ last, int32_t* __restrict__ positions,
               uint8_t* __restrict__ out) {
  const int i = blockIdx.x * kRoundThreads + threadIdx.x;
  if (i < take) {
    const int p = jump[positions[i]];
    positions[filled + i] = p;
    out[filled + i] = last[p];
  }
  if (jump2 != nullptr && i < n) jump2[i] = jump[jump[i]];
}

constexpr size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

// The scratch of the next pointers: two key buffers, then the words zeroed
// once per call (the histogram, the pass's ticket, the status words); the
// inverse's adds its two pointer buffers and the positions.
struct Layout {
  size_t keys, sorted, zero, hist, ticket, status, next_bytes, jump, jump2, positions, bytes;
  Layout(int n, int N) {
    keys = 0;
    sorted = align256(8 * static_cast<size_t>(n));
    zero = sorted + align256(8 * static_cast<size_t>(n));
    hist = zero;
    ticket = hist + 4 * kBins;
    status = ticket + 4;
    next_bytes = align256(status + 4 * static_cast<size_t>(tiles_of(n)) * kBins);
    jump = next_bytes;
    jump2 = jump + align256(4 * static_cast<size_t>(N));
    positions = jump2 + align256(4 * static_cast<size_t>(N));
    bytes = positions + align256(4 * static_cast<size_t>(n));
  }
};

// Enqueues the next pointers of last[:n] into nxt[N]; adds the launches
// to *launched.
int enqueue_next(const uint8_t* last, int n, int N, unsigned char* b, const Layout& L,
                 int32_t* nxt, int* launched, cudaStream_t st) {
  if (n > 0) {
    if (cudaError_t e = cudaMemsetAsync(b + L.zero, 0, L.next_bytes - L.zero, st)) {
      return static_cast<int>(e);
    }
    auto* keys = reinterpret_cast<int64_t*>(b + L.keys);
    auto* hist = reinterpret_cast<uint32_t*>(b + L.hist);
    const int grid = tiles_of(n);
    ibwt_keys<<<grid, kThreads, 0, st>>>(last, n, keys, hist);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    ++*launched;
    int64_t* const bufs[2] = {reinterpret_cast<int64_t*>(b + L.sorted), keys};
    const int rc = enqueue_passes(keys, bufs, n, kPosBits, kPosBits + kDigitBits, hist,
                                  reinterpret_cast<uint32_t*>(b + L.status),
                                  reinterpret_cast<uint32_t*>(b + L.ticket), launched, st);
    if (rc != 0) return rc;
  }
  if (N > 0) {
    ibwt_nxt<<<(N + kRoundThreads - 1) / kRoundThreads, kRoundThreads, 0, st>>>(
        reinterpret_cast<const int64_t*>(b + L.sorted), n, N, nxt);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    ++*launched;
  }
  return 0;
}

bool sizes_ok(int n, int N) { return n >= 0 && n <= N && n <= (1 << kMaxLog2) && N < (1 << 30); }

}  // namespace
}  // namespace radix
}  // namespace tpubz

using tpubz::radix::Layout;

// sizes[0]: the scratch bytes of the next pointers of n of N bytes;
// sizes[1]: the inverse's. Returns cudaErrorInvalidValue for sizes the
// calls do not take, else 0.
extern "C" int tpubz_ibwt_sizes(int n, int N, long long* sizes) {
  if (!tpubz::radix::sizes_ok(n, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(n, N);
  sizes[0] = static_cast<long long>(L.next_bytes);
  sizes[1] = static_cast<long long>(L.bytes);
  return 0;
}

// last: device uint8[N], the first n the column (n <= 2^20); scratch:
// device memory of sizes[0] bytes, 256-byte aligned; nxt: device
// int32[N]. Enqueues the next pointers on `stream`, writes its kernel
// launches to *launched and returns cudaGetLastError() as an int.
extern "C" int tpubz_next_pointers(const void* last, int n, int N, void* scratch,
                                   long long scratch_bytes, void* nxt, int* launched,
                                   void* stream) {
  *launched = 0;
  if (!tpubz::radix::sizes_ok(n, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(n, N);
  if (static_cast<size_t>(scratch_bytes) < L.next_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return tpubz::radix::enqueue_next(static_cast<const uint8_t*>(last), n, N,
                                    static_cast<unsigned char*>(scratch), L,
                                    static_cast<int32_t*>(nxt), launched,
                                    static_cast<cudaStream_t>(stream));
}

// The inverse of the BWT (key, last[:n]): last as tpubz_next_pointers,
// 0 <= key < n (any key when n is 0); scratch: sizes[1] bytes, 256-byte
// aligned; out: device uint8[n]. Enqueues the next pointers and every
// doubling round on `stream`; *launched gets the next pointers' kernel
// launches and *rounds the doubling rounds. Returns cudaGetLastError() as
// an int.
extern "C" int tpubz_bwt_inverse(const void* last, int key, int n, int N, void* scratch,
                                 long long scratch_bytes, void* out, int* launched, int* rounds,
                                 void* stream) {
  using namespace tpubz::radix;
  *launched = 0;
  *rounds = 0;
  if (!sizes_ok(n, N) || (n > 0 && (key < 0 || key >= n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L(n, N);
  if (static_cast<size_t>(scratch_bytes) < L.bytes) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* b = static_cast<unsigned char*>(scratch);
  const auto* col = static_cast<const uint8_t*>(last);
  auto* jump = reinterpret_cast<int32_t*>(b + L.jump);
  if (int rc = enqueue_next(col, n, N, b, L, jump, launched, st)) return rc;
  if (n == 0) return 0;
  auto* positions = reinterpret_cast<int32_t*>(b + L.positions);
  auto* dst = static_cast<uint8_t*>(out);
  ibwt_seed<<<1, 1, 0, st>>>(jump, key, col, positions, dst);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  int32_t* other = reinterpret_cast<int32_t*>(b + L.jump2);
  for (int filled = 1; filled < n;) {
    const int take = filled < n - filled ? filled : n - filled;
    const bool more = filled + take < n;
    const int width = more ? n : take;
    ibwt_round<<<(width + kRoundThreads - 1) / kRoundThreads, kRoundThreads, 0, st>>>(
        jump, more ? other : nullptr, n, filled, take, col, positions, dst);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    ++*rounds;
    filled += take;
    int32_t* t = jump;
    jump = other;
    other = t;
  }
  return 0;
}

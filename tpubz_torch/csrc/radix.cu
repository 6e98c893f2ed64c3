// The radix sort as a call of its own: int64 keys ordered by their bits
// [lo, hi), stable, keys only (tpubz_torch/kernels/radix.py:radix_sort).
// The kernels of the passes are csrc/radix.cuh's, which csrc/bwt.cu runs
// inside the BWT's call; this file adds the histogram launch of plain keys.
//
// Replaces, on the BWT's path, the bitonic sorts of csrc/bitonic.cu (the
// counterparts of tools/probe_pallas_sort.py:110 bitonic_1op and :121
// bitonic_2op), which stay as they are. The TPU sorted with a network
// because it has no fast scatter; an H100 scatters through its L2, so a
// sort of n keys costs passes * 16 bytes a key (radix.cuh) in place of the
// network's 210 compare-exchange passes over 2^20 lanes.
#include <cuda_runtime.h>

#include <cstdint>

#include "radix.cuh"

namespace tpubz {
namespace radix {
namespace {  // the header's: one internal namespace in this source

// One tile of keys a CTA: every pass's digit counts into the sort's.
__global__ void __launch_bounds__(kThreads)
    radix_histogram(const int64_t* __restrict__ keys, int n, int lo, int hi, uint32_t* hist) {
  __shared__ uint32_t s_hist[kMaxPasses << kDigitBits];
  const int passes = passes_of(lo, hi);
  for (int x = threadIdx.x; x < passes << kDigitBits; x += kThreads) s_hist[x] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
#pragma unroll 4
  for (int j = 0; j < kPer; ++j) {
    const int q = base + j * kThreads + threadIdx.x;
    hist_add(s_hist, q < n ? keys[q] : 0, q < n, lo, hi);
  }
  hist_flush(s_hist, hist, passes);
}

constexpr size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

// The scratch: a second key buffer, then the words zeroed once per call:
// the histogram (kMaxPasses digit counts), a ticket per pass, the status
// words.
struct Layout {
  size_t tmp, zero, hist, tickets, status, bytes;
  explicit Layout(int n) {
    tmp = 0;
    zero = align256(8 * static_cast<size_t>(n));
    hist = zero;
    tickets = hist + static_cast<size_t>(kMaxPasses) * kBins * 4;
    status = tickets + 4 * kMaxPasses;
    bytes = status + static_cast<size_t>(tiles_of(n)) * kBins * 4;
  }
};

}  // namespace
}  // namespace radix
}  // namespace tpubz

using tpubz::radix::Layout;
using tpubz::radix::kThreads;

// sizes[0]: the scratch bytes of a sort of n keys; sizes[1]: the digit's
// bits, so that no caller repeats them. Returns 0.
extern "C" int tpubz_radix_sizes(int n, int* sizes) {
  sizes[0] = static_cast<int>(Layout(n).bytes);
  sizes[1] = tpubz::radix::kDigitBits;
  return 0;
}

// keys: device int64[n], 0 < n <= 2^20; out: device int64[n], not keys;
// 0 <= lo < hi <= 63; scratch: device memory of the bytes
// tpubz_radix_sizes gives, 256-byte aligned. Enqueues the sort on `stream`,
// writes its kernel launches to *launched and returns cudaGetLastError() as
// an int (0 on success).
extern "C" int tpubz_radix_sort(const void* keys, void* out, int n, int lo, int hi,
                                void* scratch, int scratch_bytes_given, int* launched,
                                void* stream) {
  *launched = 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > (1 << tpubz::radix::kMaxLog2) || lo < 0 || hi <= lo || hi > 63 || keys == out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L(n);
  if (static_cast<size_t>(scratch_bytes_given) < L.bytes) return static_cast<int>(cudaErrorInvalidValue);
  auto* b = static_cast<unsigned char*>(scratch);
  if (cudaError_t e = cudaMemsetAsync(b + L.zero, 0, L.bytes - L.zero, st)) return static_cast<int>(e);
  auto* hist = reinterpret_cast<uint32_t*>(b + L.hist);
  const auto* in = static_cast<const int64_t*>(keys);
  const int grid = tpubz::radix::tiles_of(n);
  tpubz::radix::radix_histogram<<<grid, kThreads, 0, st>>>(in, n, lo, hi, hist);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  ++*launched;
  int64_t* const bufs[2] = {static_cast<int64_t*>(out), reinterpret_cast<int64_t*>(b + L.tmp)};
  return tpubz::radix::enqueue_passes(in, bufs, n, lo, hi, hist,
                                      reinterpret_cast<uint32_t*>(b + L.status),
                                      reinterpret_cast<uint32_t*>(b + L.tickets), launched, st);
}

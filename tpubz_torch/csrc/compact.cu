// The compact transfer form of RLE2 symbol rows on the card: the low byte of
// every symbol, and a sidecar of the rare symbols >= 256 in position order,
// in one kernel launched by one library call.
//
// Replaces tpubz/block/encode.py:_stage_compact (vmapped over the block rows
// in tpubz/dist/sharded.py), an XLA program of a cumsum of flags and a
// scatter. Its outputs, bit for bit: syms_u8 = the symbols' low bytes (256
// becomes 0, 257 becomes 1); hi_packed[k] = (pos << 1) | (sym - 256) of the
// k-th symbol >= 256 before rle2_len, for k < HI_CAP, and 0 past the last;
// hi_count = the number of such symbols, those past the cap included.
//
//   compact_rows  one CTA per tile of 4096 symbols of a row (grid dimension
//                 y: the row). It takes a tile ticket from its row's atomic
//                 counter, so that the tiles before it are held by CTAs that
//                 already run, writes the tile's low bytes, ranks its
//                 flags with a block-wide scan (csrc/block_scan.cuh), finds
//                 the flags of the tiles before it by decoupled look-back
//                 over per-tile status words, and writes its sidecar
//                 entries below the cap. The row's last tile writes the
//                 count.
//
// What bounds it on an H100: 2 bytes a symbol in and 1 out (2.7 MB a
// level-9 row, 0.81 us at 3.35 TB/s), plus 4 bytes a sidecar entry; the
// flags and the scan are a few integer instructions a symbol. The sidecar
// is zeroed by the call (cudaMemsetAsync) and written sparsely.
#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;  // symbols a thread holds, consecutive
constexpr int kTile = kThreads * kPer;
constexpr int kHiCap = 8192;  // tpubz/block/encode.py:HI_CAP
// A status word: the count of flags in bits 0-29, the flag in bits 30-31
// (1: this tile's own count, 2: the count of every tile up to it)
constexpr uint32_t kCountMask = (1u << 30) - 1;
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kInclusive = 2u << 30;

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// status: tiles words a row, zero; tickets: a word a row, zero.
__global__ void __launch_bounds__(kThreads)
    compact_rows(const uint16_t* __restrict__ syms, const int32_t* __restrict__ rle2_len,
                 int out_len, uint32_t* status, uint32_t* tickets, uint8_t* __restrict__ syms_u8,
                 int32_t* __restrict__ hi_packed, int32_t* __restrict__ hi_count) {
  __shared__ int sh[32];
  __shared__ int s_tile, s_before;
  const size_t row = blockIdx.y;
  const int tiles = gridDim.x;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(tickets + row, 1u));
  __syncthreads();
  const int tile = s_tile;
  syms += row * out_len;
  syms_u8 += row * out_len;
  hi_packed += row * kHiCap;
  status += row * tiles;
  const int len = rle2_len[row];
  const int base = tile * kTile + threadIdx.x * kPer;
  int s[kPer];
  int flags = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + k;
    s[k] = i < out_len ? syms[i] : 0;
    if (i < out_len) syms_u8[i] = static_cast<uint8_t>(s[k]);
    flags += i < len && s[k] >= 256;
  }
  int tile_flags;
  int rank = tpubz::block_exclusive(flags, 0, tpubz::Sum(), sh, &tile_flags);
  if (threadIdx.x == 0) {
    st_relaxed(status + tile, (tile == 0 ? kInclusive : kAggregate) | tile_flags);
    // the flags of the tiles before: back to the first inclusive count
    int before = 0;
    for (int t = tile - 1; t >= 0;) {
      const uint32_t word = ld_relaxed(status + t);
      if (word == 0) continue;  // not yet
      before += static_cast<int>(word & kCountMask);
      if ((word & ~kCountMask) == kInclusive) break;
      --t;
    }
    if (tile > 0) st_relaxed(status + tile, kInclusive | (before + tile_flags));
    if (tile == tiles - 1) hi_count[row] = before + tile_flags;
    s_before = before;
  }
  __syncthreads();
  rank += s_before;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + k;
    if (i < len && s[k] >= 256) {
      if (rank < kHiCap) hi_packed[rank] = (i << 1) | (s[k] - 256);
      ++rank;
    }
  }
}

}  // namespace

// syms: device uint16[B, out_len], row b's first rle2_len[b] symbols (device
// int32[B]) the stream. scratch: device uint32 of B * (tiles + 1) words,
// tiles = ceil(out_len / 4096). syms_u8: device uint8[B, out_len];
// hi_packed: device int32[B, 8192]; hi_count: device int32[B]. Zeroes the
// scratch and hi_packed, launches the kernel on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int tpubz_stage_compact(const void* syms, const void* rle2_len, int B, int out_len,
                                   void* scratch, void* syms_u8, void* hi_packed, void* hi_count,
                                   void* stream) {
  if (B < 1 || B > 65535 || out_len < 1 || out_len >= (1 << 29)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int tiles = (out_len + kTile - 1) / kTile;
  auto* status = static_cast<uint32_t*>(scratch);
  uint32_t* tickets = status + static_cast<size_t>(B) * tiles;
  if (cudaError_t e = cudaMemsetAsync(scratch, 0, 4 * static_cast<size_t>(B) * (tiles + 1), st)) {
    return static_cast<int>(e);
  }
  if (cudaError_t e = cudaMemsetAsync(hi_packed, 0, 4 * static_cast<size_t>(B) * kHiCap, st)) {
    return static_cast<int>(e);
  }
  compact_rows<<<dim3(tiles, B), kThreads, 0, st>>>(
      static_cast<const uint16_t*>(syms), static_cast<const int32_t*>(rle2_len), out_len, status,
      tickets, static_cast<uint8_t*>(syms_u8), static_cast<int32_t*>(hi_packed),
      static_cast<int32_t*>(hi_count));
  return static_cast<int>(cudaGetLastError());
}

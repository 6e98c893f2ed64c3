// The compact transfer form of RLE2 symbol rows on the card: the low byte of
// every symbol, and a sidecar of the rare symbols >= 256 in position order,
// in one kernel launched by one library call, and no memset.
//
// Replaces tpubz/block/encode.py:_stage_compact (vmapped over the block rows
// in tpubz/dist/sharded.py), an XLA program of a cumsum of flags and a
// scatter. Its outputs, bit for bit: syms_u8 = the symbols' low bytes (256
// becomes 0, 257 becomes 1); hi_packed[k] = (pos << 1) | (sym - 256) of the
// k-th symbol >= 256 before rle2_len, for k < HI_CAP, and 0 past the last;
// hi_count = the number of such symbols, those past the cap included.
//
//   compact_rows  one CTA a tile of 8192 symbols of a row, 32 consecutive a
//                 thread, so that five level-9 rows are one wave. The CTAs
//                 take one ticket counter of the call
//                 (csrc/look_back.cuh), ticket = row * tiles + tile, so
//                 that the tiles before a tile of its row are held by CTAs
//                 that already run; each row has its own status words. A
//                 row's tiles start `shift` symbols early, shift the number
//                 of symbols the row starts past a 16-byte boundary, so that
//                 a thread loads its 32 symbols with four 16-byte loads;
//                 the threads whose symbols cross the row's start or end
//                 load them one by one. A thread stores its 32 low bytes as
//                 whole words of the widest width the row's alignment allows
//                 (16, 8 or 4 bytes: a level-9 row of N + 8 symbols starts 0
//                 or 8 bytes past a boundary), ranks its flags with a
//                 block-wide scan (csrc/block_scan.cuh), publishes the
//                 tile's count,
//                 finds the flags of the tiles before it by one warp's
//                 decoupled look-back, and writes its sidecar entries below
//                 the cap. The row's last tile writes the count and zeroes
//                 the sidecar's entries from min(count, cap) to the cap with
//                 16-byte stores: the other tiles write only entries below
//                 the count, so the two never meet.
//
// What bounds it on an H100: 2 bytes a symbol in and 1 out (2.7 MB a
// level-9 row, 0.81 us at 3.35 TB/s), plus the 32 KB sidecar a row; the
// flags and the scan are a few integer instructions a symbol.
#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"
#include "look_back.cuh"

namespace {

using tpubz::Status;

constexpr int kThreads = 256;
constexpr int kPer = 32;  // symbols a thread holds, consecutive
constexpr int kTile = kThreads * kPer;
// CTAs an SM holds at once: five level-9 rows (550 tiles) in one wave of
// 132 SMs (at 16 symbols a thread, 1,100 tiles took two)
constexpr int kMinCtas = 5;
constexpr int kHiCap = 8192;  // tpubz/block/encode.py:HI_CAP
constexpr int kShiftMax = 7;  // symbols a row may start past a 16-byte boundary

// The symbol k of a thread's packed pairs
__device__ __forceinline__ uint32_t sym(const uint32_t (&pk)[kPer / 2], int k) {
  return (pk[k >> 1] >> (16 * (k & 1))) & 0xffffu;
}

// The 32 low bytes of the packed symbols at p (p + 32 inside the row), as
// whole words of the widest width p's alignment allows.
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint32_t (&pk)[kPer / 2]) {
  uint32_t q[kPer / 4];
#pragma unroll
  for (int c = 0; c < kPer / 4; ++c) q[c] = __byte_perm(pk[2 * c], pk[2 * c + 1], 0x6420);
  const auto at = reinterpret_cast<uintptr_t>(p);
  if ((at & 15) == 0) {
#pragma unroll
    for (int c = 0; c < kPer / 16; ++c) {
      reinterpret_cast<uint4*>(p)[c] =
          make_uint4(q[4 * c], q[4 * c + 1], q[4 * c + 2], q[4 * c + 3]);
    }
  } else if ((at & 7) == 0) {
#pragma unroll
    for (int c = 0; c < kPer / 8; ++c) {
      reinterpret_cast<uint2*>(p)[c] = make_uint2(q[2 * c], q[2 * c + 1]);
    }
  } else if ((at & 3) == 0) {
#pragma unroll
    for (int c = 0; c < kPer / 4; ++c) reinterpret_cast<uint32_t*>(p)[c] = q[c];
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) p[k] = static_cast<uint8_t>(sym(pk, k));
  }
}

// Grid: (tiles, B), tiles = ceil((out_len + kShiftMax) / kTile) a row; the
// CTA's row and tile come from its ticket, not its index. hi_packed: 16-byte
// aligned.
__global__ void __launch_bounds__(kThreads, kMinCtas)
    compact_rows(const uint16_t* __restrict__ syms, const int32_t* __restrict__ rle2_len,
                 int out_len, int tiles, tpubz::TileScratch sc, uint8_t* __restrict__ syms_u8,
                 int32_t* __restrict__ hi_packed, int32_t* __restrict__ hi_count) {
  __shared__ int sh[32];
  __shared__ unsigned s_ticket;
  __shared__ int s_before;
  const int tid = threadIdx.x;
  const unsigned ctas = gridDim.x * gridDim.y;
  if (tid == 0) s_ticket = tpubz::take_ticket(sc.ticket, ctas);
  __syncthreads();
  const unsigned ticket = s_ticket;
  const int row = static_cast<int>(ticket / tiles), tile = static_cast<int>(ticket % tiles);
  tpubz::clear_stale(sc.status, ctas, sc.dirty, ticket, ctas);
  Status* status = sc.status + static_cast<size_t>(row) * tiles;
  const uint16_t* in = syms + static_cast<size_t>(row) * out_len;
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(in) & 15) >> 1);
  const int row_tiles = (out_len + shift + kTile - 1) / kTile;
  if (tile >= row_tiles) {  // the row's lanes end before this tile
    if (tid == 0) status[tile] = 0;
    return;
  }
  const int len = min(max(rle2_len[row], 0), out_len);
  const int base = tile * kTile + tid * kPer - shift;
  const bool whole = base >= 0 && base + kPer <= out_len;
  uint32_t pk[kPer / 2];  // the symbols, two a word, the lower first
  if (whole) {
    const uint4* q = reinterpret_cast<const uint4*>(in + base);
#pragma unroll
    for (int c = 0; c < kPer / 8; ++c) {
      const uint4 x = q[c];
      pk[4 * c] = x.x;
      pk[4 * c + 1] = x.y;
      pk[4 * c + 2] = x.z;
      pk[4 * c + 3] = x.w;
    }
  } else {  // the row's start or end
#pragma unroll
    for (int c = 0; c < kPer / 2; ++c) {
      const int i = base + 2 * c;
      const uint32_t lo = i >= 0 && i < out_len ? in[i] : 0;
      const uint32_t hi = i + 1 >= 0 && i + 1 < out_len ? in[i + 1] : 0;
      pk[c] = lo | hi << 16;
    }
  }
  uint8_t* out = syms_u8 + static_cast<size_t>(row) * out_len;
  if (whole) {
    store_bytes(out + base, pk);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + k;
      if (i >= 0 && i < out_len) out[i] = static_cast<uint8_t>(sym(pk, k));
    }
  }
  int flags = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    flags += base + k < len && sym(pk, k) >= 256;  // lanes before 0 hold 0
  }
  int tile_flags;
  int rank = tpubz::block_exclusive(flags, 0, tpubz::Sum(), sh, &tile_flags);
  // a status word carries all it says, so relaxed accesses suffice
  if (tid == 0) {
    tpubz::st_relaxed(status + tile,
                      tpubz::status_word(sc.epoch,
                                         tile == 0 ? tpubz::kInclusive : tpubz::kAggregate,
                                         tile_flags));
  }
  if (tid < 32) {
    const long long before =
        tile > 0 ? tpubz::warp_look_back<false>(
                       status, tile, sc.epoch, tpubz::first_status<false>(status, tile, sc.epoch))
                 : 0;
    if (tid == 0) {
      if (tile > 0) {
        tpubz::st_relaxed(status + tile,
                          tpubz::status_word(sc.epoch, tpubz::kInclusive, before + tile_flags));
      }
      s_before = static_cast<int>(before);
    }
  }
  __syncthreads();
  const int before = s_before;
  int32_t* hp = hi_packed + static_cast<size_t>(row) * kHiCap;
  if (flags) {
    rank += before;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + k;
      const int v = static_cast<int>(sym(pk, k));
      if (i < len && v >= 256) {
        if (rank < kHiCap) hp[rank] = (i << 1) | (v - 256);
        ++rank;
      }
    }
  }
  if (tile == row_tiles - 1) {  // the count, and the sidecar past it zeroed
    const int count = before + tile_flags;
    if (tid == 0) hi_count[row] = count;
    const int lo = min(count, kHiCap);
    const int head = min((lo + 3) & ~3, kHiCap);
    for (int j = lo + tid; j < head; j += kThreads) hp[j] = 0;
    uint4* q = reinterpret_cast<uint4*>(hp + head);
    for (int c = tid; c < (kHiCap - head) / 4; c += kThreads) q[c] = make_uint4(0, 0, 0, 0);
  }
}

}  // namespace

// syms: device uint16[B, out_len], row b's first rle2_len[b] symbols (device
// int32[B]) the stream. scratch: the stream's look-back scratch
// (csrc/look_back.cuh), a ticket word and `capacity` status words, capacity
// at least B * ceil((out_len + 7) / 8192); epoch: this call's, not the
// previous call's on the scratch; dirty: that call's status words (the
// scratch's words past it are 0). syms_u8: device uint8[B, out_len];
// hi_packed: device int32[B, 8192], 16-byte aligned; hi_count: device
// int32[B]. Launches the kernel on `stream` (no memset) and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int tpubz_stage_compact(const void* syms, const void* rle2_len, int B, int out_len,
                                   void* scratch, long long capacity, unsigned epoch,
                                   long long dirty, void* syms_u8, void* hi_packed,
                                   void* hi_count, void* stream) {
  if (B < 1 || B > 65535 || out_len < 1 || out_len >= (1 << 29) ||
      reinterpret_cast<uintptr_t>(syms) % 2 || reinterpret_cast<uintptr_t>(hi_packed) % 16 ||
      dirty < 0 || dirty > capacity || epoch < 1 || epoch > tpubz::kEpochMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (out_len + kShiftMax + kTile - 1) / kTile;
  if (static_cast<long long>(B) * tiles > capacity ||
      static_cast<long long>(B) * tiles >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* words = static_cast<Status*>(scratch);
  const tpubz::TileScratch sc{reinterpret_cast<unsigned*>(words), words + 1, epoch, dirty};
  compact_rows<<<dim3(tiles, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(syms), static_cast<const int32_t*>(rle2_len), out_len, tiles,
      sc, static_cast<uint8_t*>(syms_u8), static_cast<int32_t*>(hi_packed),
      static_cast<int32_t*>(hi_count));
  return static_cast<int>(cudaGetLastError());
}

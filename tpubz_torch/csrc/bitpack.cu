// MSB-first bit packing on the card: variable-length fields into uint32
// words, and the Huffman payload of a block (each symbol's code through its
// group's selector) packed the same way, one kernel launched by one library
// call each, and no memset.
//
// Replaces tpubz/kernels/bitpack.py:pack_bits_device (an exclusive cumsum of
// the field lengths and two scatter-adds, each field landing in at most two
// words) and tpubz/kernels/huffman_dev.py:pack_payload (the gather of each
// symbol's code and length from the 6 x 258 tables by sel[i / 50], then
// pack_bits_device). Their outputs, bit for bit: field i takes the bits
// [off_i, off_i + bits_i) of the stream, off_i the sum of the lengths before
// it, bit 0 the top bit of word 0; words past the last field are 0, a field
// past the words given is dropped, and total is the sum of the lengths.
// Fields are 0 to 24 bits long (any length up to 32 works here; a length
// outside 0..32 is taken as the nearer end) and hold no bit above their
// length. Payload lanes at or past rle2_len are fields of 0 bits.
//
//   pack_tiles  one CTA a tile of 4096 lanes, 16 consecutive a thread, taken
//               by ticket (csrc/look_back.cuh), so that the tiles before it
//               are held by CTAs that already run. Tile t zeroes its slice
//               of the words, [4096 t, 4096 (t + 1)), with 16-byte stores. A
//               tile that holds lanes of the stream (the payload form: its
//               first lane below rle2_len) does so while its loads are in
//               flight: it loads its fields (16-byte loads; the payload form
//               gathers them from the tables, which only these tiles copy
//               to shared memory), ranks the threads' bit counts with a
//               block-wide scan
//               (csrc/block_scan.cuh), publishes its count, and builds its
//               words in shared memory, counted from its own first bit, by
//               one shared atomicOr a field's word and no branch a field (a
//               register that gathered a word's fields first, with branches
//               a field, was slower on an H100: PERF.md §6); then one
//               warp finds the bits of the tiles before it by decoupled
//               look-back (acquire loads). After a barrier the tile stores
//               its words, shifted to its first bit, with plain coalesced
//               stores; only a word it shares with a neighbouring tile, its
//               first or its last, goes through a global atomicOr. Thread 0
//               meanwhile publishes the inclusive count (a release) and,
//               in the tile that holds the stream's last lane, the total. A
//               tile past the stream zeroes its slice and exits: no tables,
//               no scan, no look-back.
//
// Why the words need no memset: a field is at most 32 bits, so the fields of
// tiles 0..t end before bit 4096 (t + 1) * 32, and tile t writes only words
// below 4096 (t + 1): words in the slices of tiles 0..t. Its own slice it
// zeroed before; every other one, tile s < t zeroed before it published its
// count (a release store), and tile t writes only
// after its look-back has read, with an acquire, a count that covers tile s
// (tile s's own, or an inclusive count published after a look-back that
// covered it). The grid has a tile for every slice of the words given,
// so a word past the stream, and past every tile's lanes, is zeroed too.
//
// The lanes of a tile start `shift` lanes early, shift the number of lanes
// the primary array (the values, or the symbols) starts past a 16-byte
// boundary: a thread's 16 lanes then start on a boundary, and it loads them
// with 16-byte loads. The threads whose lanes cross the start or the end of
// the array (or the stream) load lane by lane, and so do the lengths when
// they do not share the values' alignment (a batch row or a slice may start
// at any element).
//
// The payload form skips a zero-length field before any shift: tpubz shifts
// by 32 - end and masks after (an over-wide shift is 0 in XLA), but x << 32
// is undefined in C++.
//
// What bounds it on an H100: 8 bytes a field in (value and length) and 4 a
// word out; the payload form reads the symbols (4 or 2 bytes a lane) and the
// selectors instead and writes every word it is given (2.25 MB at level 9):
// bytes, at 3.35 TB/s.
#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"
#include "look_back.cuh"

namespace {

using tpubz::Status;

constexpr int kThreads = 256;
constexpr int kPer = 16;  // lanes a thread holds, consecutive
constexpr int kTile = kThreads * kPer;
constexpr int kMaxBits = 32;  // a field's longest
constexpr int kSlice = kTile * kMaxBits / 32;  // the words a tile zeroes
constexpr int kGroup = 50;    // symbols a selector covers
constexpr int kAlpha = 258;   // a table's symbols
constexpr int kTables = 6;

enum Form { kArray = 0, kPayload32 = 1, kPayload16 = 2 };

struct PackArgs {
  const uint32_t* vals;  // kArray: the fields
  const int32_t* bits;
  const void* syms;      // payload forms: int32 or uint16 symbols
  const void* rle2_len;  // device scalar, int64 or int32, or null: len_value
  int len_bytes;
  long long len_value;
  const int8_t* sel;
  const uint32_t* codes;  // [6, 258]
  const int32_t* lens;    // [6, 258]
  int m;                  // fields (lanes)
  long long out_words;
  int shift;  // lanes the primary array starts past a 16-byte boundary
  tpubz::TileScratch sc;
  uint32_t* words;  // 16-byte aligned
  long long* total;
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 consecutive 32-bit elements from a 16-byte aligned address
__device__ __forceinline__ void load_x4(const void* p, uint32_t (&v)[kPer]) {
  const uint4* q = static_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < kPer / 4; ++c) {
    const uint4 x = q[c];
    v[4 * c] = x.x;
    v[4 * c + 1] = x.y;
    v[4 * c + 2] = x.z;
    v[4 * c + 3] = x.w;
  }
}

// 16 consecutive uint16 from a 16-byte aligned address
__device__ __forceinline__ void load_x8(const uint16_t* p, uint32_t (&v)[kPer]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < kPer / 8; ++c) {
    const uint4 x = q[c];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * c + 2 * j] = w[j] & 0xffffu;
      v[8 * c + 2 * j + 1] = w[j] >> 16;
    }
  }
}

__device__ __forceinline__ int clamp_bits(int b) { return min(max(b, 0), kMaxBits); }

// Tile t's slice of the words, [t * kSlice, (t + 1) * kSlice) cut at
// out_words, zeroed by the CTA.
__device__ __forceinline__ void zero_slice(uint32_t* words, long long out_words, int tile) {
  const long long lo = static_cast<long long>(tile) * kSlice;
  if (lo >= out_words) return;
  const int n = static_cast<int>(min(static_cast<long long>(kSlice), out_words - lo));
  uint4* q = reinterpret_cast<uint4*>(words + lo);
  for (int c = threadIdx.x; c < n / 4; c += kThreads) q[c] = make_uint4(0, 0, 0, 0);
  for (int j = (n & ~3) + threadIdx.x; j < n; j += kThreads) words[lo + j] = 0;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads) pack_tiles(PackArgs a) {
  constexpr bool kGather = kForm != kArray;
  constexpr int kTab = kGather ? kTables * kAlpha : 1;
  __shared__ __align__(16) uint32_t s_words[kSlice + 4];  // the tile's words from its first bit
  __shared__ __align__(16) uint32_t s_codes[kTab];
  __shared__ __align__(16) uint8_t s_lens[kTab];
  __shared__ int sh[32];
  __shared__ int s_tile;
  __shared__ long long s_before;
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = static_cast<int>(tpubz::take_ticket(a.sc.ticket, gridDim.x));
  long long len = a.m;  // the stream's lanes
  if constexpr (kGather) {
    if (a.rle2_len != nullptr) {
      len = a.len_bytes == 8 ? *static_cast<const long long*>(a.rle2_len)
                             : *static_cast<const int*>(a.rle2_len);
    } else {
      len = a.len_value;
    }
    len = min(max(len, 0ll), static_cast<long long>(a.m));
  }
  const int stream_tiles = len > 0 ? static_cast<int>((len + a.shift + kTile - 1) / kTile) : 0;
  __syncthreads();
  const int tile = s_tile;
  tpubz::clear_stale(a.sc.status, stream_tiles, a.sc.dirty, tile, gridDim.x);
  if (tile >= stream_tiles) {  // past the stream (an empty stream: tile 0 writes the total)
    zero_slice(a.words, a.out_words, tile);
    if (tile == 0 && tid == 0) *a.total = 0;
    return;
  }

  const long long base = static_cast<long long>(tile) * kTile + tid * kPer - a.shift;
  uint32_t v[kPer];
  int b[kPer];
  if constexpr (kForm == kArray) {
    uint32_t raw[kPer];
    if (base >= 0 && base + kPer <= a.m) {
      load_x4(a.vals + base, v);
      if (aligned16(a.bits + base)) {
        load_x4(a.bits + base, raw);
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) raw[k] = a.bits[base + k];
      }
    } else {  // the array's start or end
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const long long i = base + k;
        const bool in = i >= 0 && i < a.m;
        v[k] = in ? a.vals[i] : 0;
        raw[k] = in ? a.bits[i] : 0;
      }
    }
    zero_slice(a.words, a.out_words, tile);  // while the loads are in flight
#pragma unroll
    for (int k = 0; k < kPer; ++k) b[k] = clamp_bits(static_cast<int>(raw[k]));
  } else {
    // the tables: 16-byte loads (lane by lane when a table is off a
    // 16-byte boundary), then the symbols' and the selectors', every load in
    // flight at once before the slice's stores, which a later load would
    // queue behind; the stores to shared memory after
    constexpr int kVecs = kTab / 4;  // 387 of four entries
    constexpr int kRounds = (kVecs + kThreads - 1) / kThreads;
    const bool vec = aligned16(a.codes) && aligned16(a.lens);
    uint4 c[kRounds], l[kRounds];
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const int k = tid + q * kThreads;
      c[q] = l[q] = make_uint4(0, 0, 0, 0);
      if (k < kVecs) {
        if (vec) {
          c[q] = reinterpret_cast<const uint4*>(a.codes)[k];
          l[q] = reinterpret_cast<const uint4*>(a.lens)[k];
        } else {
          c[q] = make_uint4(a.codes[4 * k], a.codes[4 * k + 1], a.codes[4 * k + 2],
                            a.codes[4 * k + 3]);
          l[q] = make_uint4(a.lens[4 * k], a.lens[4 * k + 1], a.lens[4 * k + 2],
                            a.lens[4 * k + 3]);
        }
      }
    }
    // the symbols and their tables; kAlpha past the stream (no field)
    uint32_t s[kPer];
    int t[kPer];
    const bool whole = base >= 0 && base + kPer <= len;
    int t0 = 0, t1 = 0, cut = kPer;  // a whole thread's 16 lanes span at most two groups
    if (whole) {
      if constexpr (kForm == kPayload32) {
        load_x4(static_cast<const int32_t*>(a.syms) + base, s);
      } else {
        load_x8(static_cast<const uint16_t*>(a.syms) + base, s);
      }
      const long long g0 = base / kGroup;
      t0 = a.sel[g0];
      cut = static_cast<int>((g0 + 1) * kGroup - base);
      if (cut < kPer) t1 = a.sel[g0 + 1];
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const long long i = base + k;
        const bool in = i >= 0 && i < len;
        s[k] = kAlpha;
        t[k] = 0;
        if (in) {
          s[k] = kForm == kPayload32
                     ? static_cast<uint32_t>(static_cast<const int32_t*>(a.syms)[i])
                     : static_cast<const uint16_t*>(a.syms)[i];
          t[k] = a.sel[i / kGroup];
        }
      }
    }
    zero_slice(a.words, a.out_words, tile);  // while the loads are in flight
    if (whole) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) t[k] = k < cut ? t0 : t1;
    }
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const int k = tid + q * kThreads;
      if (k < kVecs) {
        reinterpret_cast<uint4*>(s_codes)[k] = c[q];
        reinterpret_cast<uint32_t*>(s_lens)[k] =
            clamp_bits(static_cast<int>(l[q].x)) | clamp_bits(static_cast<int>(l[q].y)) << 8 |
            clamp_bits(static_cast<int>(l[q].z)) << 16 | clamp_bits(static_cast<int>(l[q].w)) << 24;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      v[k] = 0;
      b[k] = 0;
      if (s[k] < kAlpha && static_cast<unsigned>(t[k]) < kTables) {
        v[k] = s_codes[t[k] * kAlpha + s[k]];
        b[k] = s_lens[t[k] * kAlpha + s[k]];
      }
    }
  }
  // the tile's words in shared memory zeroed; the scan's barriers order
  // this before they are built
  for (int c = tid; c < (kSlice + 4) / 4; c += kThreads) {
    reinterpret_cast<uint4*>(s_words)[c] = make_uint4(0, 0, 0, 0);
  }
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) sum += b[k];
  int tile_bits;
  const int off = tpubz::block_exclusive(sum, 0, tpubz::Sum(), sh, &tile_bits);
  // the scan's barriers order every thread's zeroing before the release;
  // the last thread publishes (a release store holds its warp ~0.35 us on
  // an H100: its warp has the fewest words to store, warp 0 looks back)
  const unsigned epoch = a.sc.epoch;
  constexpr int kPublisher = kThreads - 1;
  if (tid == kPublisher) {
    tpubz::st_release(a.sc.status + tile,
                      tpubz::status_word(epoch, tile == 0 ? tpubz::kInclusive : tpubz::kAggregate,
                                         tile_bits));
  }
  // the tile's words, counted from its own first bit
  {
    int pos = off;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int wi = pos >> 5;
      const int end = (pos & 31) + b[k];
      if (b[k]) {  // no shift by 32
        atomicOr(s_words + wi, end <= 32 ? v[k] << (32 - end) : v[k] >> (end - 32));
        if (end > 32) atomicOr(s_words + wi + 1, v[k] << (64 - end));
      }
      pos += b[k];
    }
  }
  // then warp 0 finds the bits before the tile (acquiring what the tiles
  // before released with their counts: their zeroed words)
  if (tid < 32) {
    const long long before =
        tile > 0 ? tpubz::warp_look_back<true>(a.sc.status, tile, epoch,
                                               tpubz::first_status<true>(a.sc.status, tile, epoch))
                 : 0;
    if (tid == 0) s_before = before;
  }
  __syncthreads();
  const long long before = s_before;
  if (tid == kPublisher) {  // the inclusive count, a release of all the look-back acquired
    if (tile > 0) {
      tpubz::st_release(a.sc.status + tile,
                        tpubz::status_word(epoch, tpubz::kInclusive, before + tile_bits));
    }
    if (tile == stream_tiles - 1) *a.total = before + tile_bits;
  }

  // word j of the output, w0 + j, is s_words shifted right by the tile's
  // first bit in its word; the first and the last may be shared
  const int r = static_cast<int>(before & 31);
  const long long w0 = before >> 5;
  const int nout = tile_bits ? (r + tile_bits + 31) >> 5 : 0;
  const bool head_shared = r != 0, tail_shared = ((r + tile_bits) & 31) != 0;
  for (int j = tid; j < nout; j += kThreads) {
    const long long gw = w0 + j;
    if (gw >= a.out_words) break;
    const uint32_t x = r ? (s_words[j] >> r) | (j ? s_words[j - 1] << (32 - r) : 0u) : s_words[j];
    if ((j == 0 && head_shared) || (j == nout - 1 && tail_shared)) {
      if (x) atomicOr(a.words + gw, x);
    } else {
      a.words[gw] = x;
    }
  }
}

// The status words a call of m lanes may use: csrc/look_back.cuh's scratch
// holds at least this many (kernels/look_back.py:status_words).
long long status_words(int m) { return (static_cast<long long>(m) + 7 + kTile - 1) / kTile; }

int launch(int form, const void* primary, int elem, PackArgs& a, void* scratch,
           long long capacity, unsigned epoch, long long dirty, cudaStream_t st) {
  const auto addr = reinterpret_cast<uintptr_t>(primary);
  if (a.m < 1 || a.m >= (1 << 30) || a.out_words < 1 || !aligned16(a.words) || addr % elem ||
      status_words(a.m) > capacity || dirty < 0 || dirty > capacity || epoch < 1 ||
      epoch > tpubz::kEpochMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.shift = static_cast<int>((addr & 15) / elem);
  const long long lane_tiles = (static_cast<long long>(a.m) + a.shift + kTile - 1) / kTile;
  const long long ctas = max(lane_tiles, (a.out_words + kSlice - 1) / kSlice);
  if (ctas >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  auto* words = static_cast<Status*>(scratch);
  a.sc = {reinterpret_cast<unsigned*>(words), words + 1, epoch, dirty};
  const auto grid = static_cast<unsigned>(ctas);
  switch (form) {
    case kArray:
      pack_tiles<kArray><<<grid, kThreads, 0, st>>>(a);
      break;
    case kPayload32:
      pack_tiles<kPayload32><<<grid, kThreads, 0, st>>>(a);
      break;
    default:
      pack_tiles<kPayload16><<<grid, kThreads, 0, st>>>(a);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals: device uint32[m], bits: device int32[m] (0..24 each), 1 <= m < 2^30.
// scratch: the stream's look-back scratch (csrc/look_back.cuh), a ticket
// word and `capacity` status words, capacity at least ceil((m + 7) / 4096);
// epoch: this call's, not the previous call's on the scratch; dirty: that
// call's status words (the scratch's words past it are 0). words: device
// uint32[out_words], 16-byte aligned; total: device int64 scalar. Launches
// the kernel on `stream` (no memset) and returns cudaGetLastError() as an
// int (0 on success).
extern "C" int tpubz_pack_bits_device(const void* vals, const void* bits, int m,
                                      long long out_words, void* scratch, long long capacity,
                                      unsigned epoch, long long dirty, void* words, void* total,
                                      void* stream) {
  PackArgs a{};
  a.vals = static_cast<const uint32_t*>(vals);
  a.bits = static_cast<const int32_t*>(bits);
  a.m = m;
  a.out_words = out_words;
  a.words = static_cast<uint32_t*>(words);
  a.total = static_cast<long long*>(total);
  if (reinterpret_cast<uintptr_t>(bits) % 4) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kArray, vals, 4, a, scratch, capacity, epoch, dirty,
                static_cast<cudaStream_t>(stream));
}

// syms: device symbols of m lanes, int32 (sym_bytes 4) or uint16 (2), the
// first rle2_len the stream: a device int64 or int32 scalar (len_bytes 8 or
// 4), or, when rle2_len is null, len_value. sel: device int8[ceil(m / 50)];
// codes: device uint32[6, 258]; lens: device int32[6, 258]. The scratch,
// words and total as above. Returns cudaGetLastError() as an int.
extern "C" int tpubz_pack_payload(const void* syms, int sym_bytes, const void* rle2_len,
                                  int len_bytes, long long len_value, const void* sel,
                                  const void* codes, const void* lens, int m, long long out_words,
                                  void* scratch, long long capacity, unsigned epoch,
                                  long long dirty, void* words, void* total, void* stream) {
  if ((sym_bytes != 4 && sym_bytes != 2) ||
      (rle2_len != nullptr && len_bytes != 8 && len_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackArgs a{};
  a.syms = syms;
  a.rle2_len = rle2_len;
  a.len_bytes = len_bytes;
  a.len_value = len_value;
  a.sel = static_cast<const int8_t*>(sel);
  a.codes = static_cast<const uint32_t*>(codes);
  a.lens = static_cast<const int32_t*>(lens);
  a.m = m;
  a.out_words = out_words;
  a.words = static_cast<uint32_t*>(words);
  a.total = static_cast<long long*>(total);
  return launch(sym_bytes == 4 ? kPayload32 : kPayload16, syms, sym_bytes, a, scratch, capacity,
                epoch, dirty, static_cast<cudaStream_t>(stream));
}

// MSB-first bit packing on the card: variable-length fields into uint32
// words, and the Huffman payload of a block (each symbol's code through its
// group's selector) packed the same way, one kernel launched by one library
// call each.
//
// Replaces tpubz/kernels/bitpack.py:pack_bits_device (an exclusive cumsum of
// the field lengths and two scatter-adds, each field landing in at most two
// words) and tpubz/kernels/huffman_dev.py:pack_payload (the gather of each
// symbol's code and length from the 6 x 258 tables by sel[i / 50], then
// pack_bits_device). Their outputs, bit for bit: field i takes the bits
// [off_i, off_i + bits_i) of the stream, off_i the sum of the lengths before
// it, bit 0 the top bit of word 0; words past the last field are 0, a field
// past the words given is dropped, and total is the sum of the lengths.
// Fields are 0 to 24 bits long (at most 32 here) and hold no bit above their
// length. Payload lanes at or past rle2_len are fields of 0 bits.
//
//   pack_tiles  one CTA per tile of 4096 fields (16 a thread, consecutive).
//               It takes a tile ticket, so that the tiles before it are held
//               by CTAs that already run; loads its fields (the payload form
//               gathers them from the tables, copied to shared memory);
//               ranks the threads' bit counts with a block-wide scan
//               (csrc/block_scan.cuh); finds the bits of the tiles before it
//               by decoupled look-back over per-tile 64-bit status words, as
//               csrc/compact.cu does; and ORs each field into its word or
//               two. A thread gathers its consecutive fields of one word in
//               a register and ORs the word once. Bit ranges are disjoint,
//               so OR is tpubz's add, in any order. The last tile writes the
//               total.
//
// The payload form skips a zero-length field before any shift: tpubz shifts
// by 32 - end and masks after (an over-wide shift is 0 in XLA), but x << 32
// is undefined in C++.
//
// What bounds it on an H100: 8 bytes a field in (value and length) and 4 a
// word out; the payload form reads the symbols (4 or 2 bytes a lane) and the
// selectors instead (3.60 MB at level 9 with int32 symbols) and writes 2.25
// MB of words: 1.75 us at 3.35 TB/s. The words are zeroed by the call
// (cudaMemsetAsync) and written by atomicOr, a few a thread: a level-9
// payload averages 2 to 3 bits a symbol, so a thread's 16 fields span 1 to
// 3 words.
#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;  // fields a thread holds, consecutive
constexpr int kTile = kThreads * kPer;
constexpr int kGroup = 50;    // symbols a selector covers
constexpr int kAlpha = 258;   // a table's symbols
constexpr int kTables = 6;
// A status word: the bits of a tile (or of every tile up to it) in bits
// 0-61, the flag in bits 62-63 (1: this tile's own bits, 2: inclusive)
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;

enum Form { kArray = 0, kPayload32 = 1, kPayload16 = 2 };

struct PackArgs {
  const uint32_t* vals;  // kArray: the fields
  const int32_t* bits;
  const void* syms;      // payload forms: int32 or uint16 symbols
  const void* rle2_len;  // device scalar, int64 or int32
  int len_bytes;
  const int8_t* sel;
  const uint32_t* codes;  // [6, 258]
  const int32_t* lens;    // [6, 258]
  int m;                  // fields (lanes)
  long long out_words;
  unsigned long long* status;  // a word a tile, zero
  unsigned int* ticket;        // zero
  uint32_t* words;             // zero
  long long* total;
};

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void or_word(const PackArgs& a, long long w, uint32_t bits) {
  if (bits && w < a.out_words) atomicOr(a.words + w, bits);
}

template <int kForm>
__global__ void __launch_bounds__(kThreads) pack_tiles(PackArgs a) {
  constexpr int kTab = kForm == kArray ? 1 : kTables * kAlpha;
  __shared__ uint32_t s_codes[kTab];
  __shared__ int32_t s_lens[kTab];
  __shared__ int sh[32];
  __shared__ int s_tile;
  __shared__ long long s_before;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(a.ticket, 1u));
  int len = 0;
  if constexpr (kForm != kArray) {
    for (int k = threadIdx.x; k < kTab; k += kThreads) {
      s_codes[k] = a.codes[k];
      s_lens[k] = a.lens[k];
    }
    len = a.len_bytes == 8 ? static_cast<int>(*static_cast<const long long*>(a.rle2_len))
                           : *static_cast<const int*>(a.rle2_len);
  }
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile + threadIdx.x * kPer;
  uint32_t v[kPer];
  int b[kPer];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + k;
    v[k] = 0;
    b[k] = 0;
    if constexpr (kForm == kArray) {
      if (i < a.m) {
        v[k] = a.vals[i];
        b[k] = a.bits[i];
      }
    } else {
      if (i < a.m && i < len) {
        const int s = kForm == kPayload32 ? static_cast<const int32_t*>(a.syms)[i]
                                          : static_cast<const uint16_t*>(a.syms)[i];
        const int t = a.sel[i / kGroup];
        if (static_cast<unsigned>(s) < kAlpha && static_cast<unsigned>(t) < kTables) {
          v[k] = s_codes[t * kAlpha + s];
          b[k] = s_lens[t * kAlpha + s];
        }
      }
    }
    sum += b[k];
  }
  int tile_bits;
  const int off = tpubz::block_exclusive(sum, 0, tpubz::Sum(), sh, &tile_bits);
  if (threadIdx.x == 0) {
    st_relaxed(a.status + tile,
               (tile == 0 ? kInclusive : kAggregate) | static_cast<unsigned long long>(tile_bits));
    // the bits of the tiles before: back to the first inclusive count
    long long before = 0;
    for (int t = tile - 1; t >= 0;) {
      const unsigned long long word = ld_relaxed(a.status + t);
      if (word == 0) continue;  // not yet
      before += static_cast<long long>(word & kValueMask);
      if ((word & ~kValueMask) == kInclusive) break;
      --t;
    }
    if (tile > 0) {
      st_relaxed(a.status + tile, kInclusive | static_cast<unsigned long long>(before + tile_bits));
    }
    if (tile == static_cast<int>(gridDim.x) - 1) *a.total = before + tile_bits;
    s_before = before;
  }
  __syncthreads();
  long long pos = s_before + off;
  long long cur = -1;  // the word the register holds
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (b[k] == 0) continue;  // no shift by 32
    const long long w = pos >> 5;
    const int end = static_cast<int>(pos & 31) + b[k];
    if (w != cur) {
      or_word(a, cur, acc);
      cur = w;
      acc = 0;
    }
    if (end <= 32) {
      acc |= v[k] << (32 - end);
    } else {  // the field's low end - 32 bits open the next word
      or_word(a, w, acc | (v[k] >> (end - 32)));
      cur = w + 1;
      acc = v[k] << (64 - end);
    }
    pos += b[k];
  }
  or_word(a, cur, acc);
}

int launch(int form, PackArgs& a, cudaStream_t st) {
  if (a.m < 1 || a.m >= (1 << 30) || a.out_words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (a.m + kTile - 1) / kTile;
  if (cudaError_t e = cudaMemsetAsync(a.status, 0, 8 * (static_cast<size_t>(tiles) + 1), st)) {
    return static_cast<int>(e);
  }
  if (cudaError_t e = cudaMemsetAsync(a.words, 0, 4 * static_cast<size_t>(a.out_words), st)) {
    return static_cast<int>(e);
  }
  a.ticket = reinterpret_cast<unsigned int*>(a.status + tiles);
  switch (form) {
    case kArray:
      pack_tiles<kArray><<<tiles, kThreads, 0, st>>>(a);
      break;
    case kPayload32:
      pack_tiles<kPayload32><<<tiles, kThreads, 0, st>>>(a);
      break;
    default:
      pack_tiles<kPayload16><<<tiles, kThreads, 0, st>>>(a);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals: device uint32[m], bits: device int32[m] (0..24 each), 1 <= m < 2^30.
// scratch: device 8 * (ceil(m / 4096) + 1) bytes. words: device
// uint32[out_words]; total: device int64 scalar. Zeroes the scratch and the
// words, launches the kernel on `stream` and returns cudaGetLastError() as
// an int (0 on success).
extern "C" int tpubz_pack_bits_device(const void* vals, const void* bits, int m,
                                      long long out_words, void* scratch, void* words,
                                      void* total, void* stream) {
  PackArgs a{};
  a.vals = static_cast<const uint32_t*>(vals);
  a.bits = static_cast<const int32_t*>(bits);
  a.m = m;
  a.out_words = out_words;
  a.status = static_cast<unsigned long long*>(scratch);
  a.words = static_cast<uint32_t*>(words);
  a.total = static_cast<long long*>(total);
  return launch(kArray, a, static_cast<cudaStream_t>(stream));
}

// syms: device symbols of m lanes, int32 (sym_bytes 4) or uint16 (2), the
// first *rle2_len (a device int64 or int32 scalar, len_bytes 8 or 4) the
// stream; sel: device int8[ceil(m / 50)]; codes: device uint32[6, 258];
// lens: device int32[6, 258]. scratch, words, total as above. Returns
// cudaGetLastError() as an int.
extern "C" int tpubz_pack_payload(const void* syms, int sym_bytes, const void* rle2_len,
                                  int len_bytes, const void* sel, const void* codes,
                                  const void* lens, int m, long long out_words, void* scratch,
                                  void* words, void* total, void* stream) {
  if ((sym_bytes != 4 && sym_bytes != 2) || (len_bytes != 8 && len_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackArgs a{};
  a.syms = syms;
  a.rle2_len = rle2_len;
  a.len_bytes = len_bytes;
  a.sel = static_cast<const int8_t*>(sel);
  a.codes = static_cast<const uint32_t*>(codes);
  a.lens = static_cast<const int32_t*>(lens);
  a.m = m;
  a.out_words = out_words;
  a.status = static_cast<unsigned long long*>(scratch);
  a.words = static_cast<uint32_t*>(words);
  a.total = static_cast<long long*>(total);
  return launch(sym_bytes == 4 ? kPayload32 : kPayload16, a, static_cast<cudaStream_t>(stream));
}

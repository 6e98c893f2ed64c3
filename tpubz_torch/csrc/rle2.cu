// RLE2 zero-run coding of MTF ranks on the card: one pass over the ranks
// with a decoupled look-back across tiles, after one memset.
//
// Replaces tpubz/kernels/rle2.py:rle2_encode, an XLA kernel of tpubz's
// device chain (a prefix max, a suffix min, an exclusive cumsum, one
// unique-index scatter and a 258-bin histogram). Its outputs, bit for bit:
// a zero run of length L becomes the floor(log2(L+1)) bijective base-2
// digits of L (RUNA=0, RUNB=1, low digit first: digit k = ((L+1) >> k) & 1),
// a rank r >= 1 becomes symbol r+1, the EOB goes at rle2_len-1, slots from
// rle2_len on are 0, and freqs counts syms[:rle2_len]. The symbols are
// tpubz's uint16 on every call.
//
// A zero run can cross any number of tiles, so a tile's output offset
// depends on the last nonzero before it: the literal that closes a run
// writes the run's digits. A tile of 4096 ranks (16 a thread, loaded once,
// 16 bytes a load) is summed up as a segment (Seg below): its first and
// last nonzero, its emit count without the digits of the run before its
// first nonzero, and (lean call) its count of rank-255 literals. Segments
// combine: a ⊕ b adds the digits of the run between a.last and b.first
// when both exist. A prefix is a segment that starts at the row's start (a
// virtual literal at position -1 that emits nothing), so its emit count is
// the output offset.
//
//   cudaMemsetAsync   zeroes the status words, the tickets, the
//                     frequencies and the symbol rows (and the lean byte
//                     stream).
//   rle2_onepass      one CTA a tile, in ticket order (an atomic counter a
//                     row, so a tile's predecessors are held by CTAs that
//                     already run): block scans of the threads' segments;
//                     the tile's aggregate published at once; each thread
//                     stages its literals and digits in shared memory, and
//                     a shared 258-bin histogram counts them, while the
//                     look-back's loads are in flight; the exclusive prefix
//                     by decoupled look-back (the CTA reads the status
//                     words of up to 256 tiles before it at once, back to
//                     the nearest inclusive prefix: a row has at most 256
//                     tiles, so all of them); the inclusive prefix
//                     published; the digits of the run before the tile's
//                     first literal and the staged slots written out
//                     contiguously; the histogram added to freqs by integer
//                     atomics, exact in any order. The row's last tile
//                     writes the trailing run's digits, the EOB and
//                     rle2_len, and counts them.
//
// Slots past rle2_len keep the memset's zeros and no tile writes them; a
// slot below it is written once, by one tile, so the tiles may write in
// any order. Zeroing each tile's slots in the kernel instead (ordered by
// release and acquire on the status words) was slower on an H100 than the
// memset (PERF.md, the RLE2 redesign).
//
// A status word is 64 bits: the flag in bits 62-63; an aggregate holds
// the emit count (13 bits), the rank-255 count (13) and the first and last
// nonzero less the tile's base (12 each; the widths follow kTile); an
// inclusive prefix the output
// offset, the rank-255 count and the last nonzero + 1 (20 bits each). So a
// row has fewer than 2^20 output slots: the entry points refuse N + 8 >=
// 2^20 (a level-9 block has N = 900,096).
//
// The batched call (tpubz_rle2_batch, the counterpart of
// tpubz/kernels/rle2.py:rle2_encode_batch) runs the same kernel with the
// row as grid dimension y: each row has its own ranks, length, EOB,
// ticket, status words and outputs, and no offset crosses a row. Its
// lengths and frequencies are int32 (tpubz's batch types), the one-block
// call's int64; they are template parameters.
//
// The lean call (tpubz_rle2_compact, the counterpart of
// tpubz/block/encode.py:_rle2_compact, RLE2 with tpubz's with_freqs=False
// and the lean transfer form) sets kLean: no histogram; beside each symbol
// slot its byte min(sym, 255) goes to a u8 stream; and the output slots of
// the rank-255 literals (symbol 256, the only body symbol >= 256: the EOB
// is never counted) go to hi_pos in input order, which is slot order,
// since RLE2's offsets grow with the input: a literal's rank among them is
// its prefix's count plus a block scan, so no sort runs, where tpubz sorts
// the flagged slots. The last tile writes entries from min(hi_count, 8192)
// to 8192 as 1 << 30 and hi_count, which counts them all. The EOB of the
// one-block and lean calls can come from the used map (its count + 1),
// taken on the card by the last tile.
//
// What bounds it on an H100: 4N bytes of ranks in and 2(N+8) of symbols out
// (5.4 MB at level 9, 1.61 us at 3.35 TB/s), and N+8 bytes of u8 stream
// more on the lean call. The ranks are read once; the memset writes the
// symbols a second time (0.54 us more at level 9). The work per rank is a
// few integer instructions, so a tile is bound by the latency of its
// chain (the ticket, the load, the block scans, the staging, the
// look-back, the write): at level 9 one wave of 220 tiles runs on 132
// SMs, and those that hold two tiles finish last.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "block_scan.cuh"

namespace {

using tpubz::block_exclusive;
using tpubz::Max;
using tpubz::Sum;

constexpr int kThreads = 256;
constexpr int kPer = 16;  // ranks a thread holds
constexpr int kTile = kThreads * kPer;
constexpr int kBins = 258;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHiCap = 8192;  // tpubz/block/encode.py:HI_CAP
constexpr int32_t kHiNone = 1 << 30;  // a hi_pos entry past the count
constexpr int kFieldBits = 20;  // a prefix's fields: every count of a row is below 2^20
constexpr int kMaxOut = 1 << kFieldBits;  // N + 8 must stay below it
constexpr int kNone = INT_MAX;  // Seg.first of a segment with no nonzero
// the bits of a position in a tile, and of a count up to the tile
constexpr int bits_for(int v) { return v > 1 ? 1 + bits_for((v + 1) / 2) : 0; }
constexpr int kOffBits = bits_for(kTile);
constexpr int kCountBits = kOffBits + 1;
static_assert(2 * kCountBits + 2 * kOffBits <= 62, "an aggregate fits beside the flag");
static_assert((kMaxOut + kTile - 1) / kTile <= kThreads, "one look-back window covers a row's tiles");

using Word = unsigned long long;
constexpr Word kAggregate = 1ull << 62;
constexpr Word kInclusive = 2ull << 62;
constexpr Word kFieldMask = (1ull << kFieldBits) - 1;

// A run of ranks: its first and last nonzero (kNone and -1 when it has
// none), its emit count without the digits of the run before its first
// nonzero, and its rank-255 literals. A prefix has first == -1.
struct Seg {
  int first, last, emit, hi;
};

__device__ __forceinline__ Seg empty_seg() { return {kNone, -1, 0, 0}; }
// the prefix before a row's first tile
__device__ __forceinline__ Seg start_seg() { return {-1, -1, 0, 0}; }

// floor(log2(L+1)) digits for a run of L zeros; none for L <= 0
__device__ __forceinline__ int num_digits(int run) {
  return run > 0 ? 31 - __clz(run + 1) : 0;
}

// a then b
__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  if (b.first == kNone) return {a.first, a.last, a.emit, a.hi + b.hi};
  if (a.first == kNone) return {b.first, b.last, b.emit, a.hi + b.hi};
  return {a.first, b.last, a.emit + num_digits(b.first - a.last - 1) + b.emit, a.hi + b.hi};
}

// an aggregate: emit, hi (kCountBits each), first and last less the tile's
// base (kOffBits each), low bits first
__device__ __forceinline__ Word pack_aggregate(const Seg& s, int base) {
  if (s.first == kNone) return kAggregate;
  return kAggregate | Word(s.emit) | Word(s.hi) << kCountBits |
         Word(s.first - base) << (2 * kCountBits) |
         Word(s.last - base) << (2 * kCountBits + kOffBits);
}

__device__ __forceinline__ Seg unpack_aggregate(Word w, int base) {
  constexpr Word kCount = (1ull << kCountBits) - 1, kOff = (1ull << kOffBits) - 1;
  const int emit = static_cast<int>(w & kCount);
  if (emit == 0) return empty_seg();  // every nonzero emits its literal
  return {base + static_cast<int>(w >> (2 * kCountBits) & kOff),
          base + static_cast<int>(w >> (2 * kCountBits + kOffBits) & kOff), emit,
          static_cast<int>(w >> kCountBits & kCount)};
}

__device__ __forceinline__ Word pack_inclusive(const Seg& p) {
  return kInclusive | Word(p.emit) | Word(p.hi) << kFieldBits |
         Word(p.last + 1) << (2 * kFieldBits);
}

__device__ __forceinline__ Seg unpack_inclusive(Word w) {
  return {-1, static_cast<int>(w >> (2 * kFieldBits) & kFieldMask) - 1,
          static_cast<int>(w & kFieldMask), static_cast<int>(w >> kFieldBits & kFieldMask)};
}

// A status word carries all it says, so relaxed accesses suffice.
__device__ __forceinline__ Word ld_relaxed(const Word* p) {
  Word v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(Word* p, Word v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ Seg shfl_seg(const Seg& s, int d) {
  return {__shfl_down_sync(kFull, s.first, d), __shfl_down_sync(kFull, s.last, d),
          __shfl_down_sync(kFull, s.emit, d), __shfl_down_sync(kFull, s.hi, d)};
}

// This thread's status word in the first window of tile `tile`'s
// look-back: tile - 1 - threadIdx.x's (words before tile 0 read as the
// row's start).
__device__ __forceinline__ Word first_word(const Word* status, int tile) {
  const int src = tile - 1 - static_cast<int>(threadIdx.x);
  return src < 0 ? kInclusive : ld_relaxed(status + src);
}

// The exclusive prefix of tile `tile` > 0: every tile before it combined.
// Called by every thread of the CTA. Thread t reads the status word of
// tile t0 - t (the first window's word `w`, from first_word, loaded
// earlier) and the CTA waits until each is published. Each warp finds its
// nearest inclusive prefix by a ballot and combines it with the aggregates
// after it by a shuffle tree (its highest lane the earliest tile); thread
// 0 then combines the warps' results from the latest back to the first
// warp that met an inclusive prefix. Without one in the window it moves
// kThreads tiles back; a row has at most kThreads tiles, so one window
// always suffices. Thread 0's return is the prefix. s_warp: kThreads / 32
// segments; s_incl: kThreads / 32 flags.
__device__ Seg look_back(const Word* status, int tile, Word w, Seg* s_warp, bool* s_incl) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  Seg acc = empty_seg();
  for (int t0 = tile - 1;; t0 -= kThreads) {
    const int src = t0 - t;
    if (t0 != tile - 1) w = src < 0 ? kInclusive : ld_relaxed(status + src);
    while (__syncthreads_or(w == 0)) {
      if (w == 0) w = ld_relaxed(status + src);
    }
    const unsigned incl = __ballot_sync(kFull, (w >> 62) == 2);
    const int k = incl ? __ffs(incl) - 1 : 32;  // the warp's nearest inclusive prefix
    Seg s = lane < k ? unpack_aggregate(w, src * kTile) : lane == k ? unpack_inclusive(w) : empty_seg();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Seg o = shfl_seg(s, d);
      if (lane + d < 32) s = combine(o, s);
    }
    if (lane == 0) {
      s_warp[warp] = s;
      s_incl[warp] = incl != 0;
    }
    __syncthreads();
    bool found = false;
    for (int v = 0; v < kThreads / 32 && !found; ++v) {
      if (t == 0) acc = combine(s_warp[v], acc);
      found = s_incl[v];
    }
    if (found) return acc;
    __syncthreads();  // s_warp is read: the next window may write it
  }
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

// count += v for a frequency slot of either width, exact in any order
__device__ __forceinline__ void add_count(int64_t* f, int v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(f), static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void add_count(int32_t* f, int v) { atomicAdd(f, v); }

// Where the EOB comes from: the used map (its count + 1), a device int64
// scalar, a device int32 a row, or the value; the first that is set.
struct Eob {
  const bool* used;
  const int64_t* i64;
  const int32_t* i32;
  int value;
};

// The lean call's outputs; null on the other calls.
struct Lean {
  uint8_t* u8;        // min(sym, 255) of every slot
  int32_t* hi_pos;    // the slots of the rank-255 literals, kHiCap entries
  int32_t* hi_count;  // their count
};

// syms[j] = v, and on the lean call u8[j] = min(v, 255)
template <bool kLean>
__device__ __forceinline__ void put(uint16_t* syms, const Lean& lean, int j, int v) {
  syms[j] = static_cast<uint16_t>(v);
  if constexpr (kLean) lean.u8[j] = static_cast<uint8_t>(min(v, 255));
}

// Grid: (tiles a row, rows). Row y's length is n_rows[y] where n_rows is
// given, else n; its status words start at status + y * nb, its ticket at
// tickets[y]; all zero before the launch, as are syms, freqs and lean.u8.
template <bool kLean, typename L, typename F>
__global__ void __launch_bounds__(kThreads)
    rle2_onepass(const int32_t* __restrict__ ranks, int n, const int32_t* __restrict__ n_rows,
                 int N, int nb, Eob eob, Word* __restrict__ status, unsigned* __restrict__ tickets,
                 uint16_t* __restrict__ syms, L* __restrict__ rle2_len, F* __restrict__ freqs,
                 Lean lean) {
  __shared__ int sh[32];
  __shared__ int s_tile, s_first;
  __shared__ Seg s_prefix;
  __shared__ Seg s_warp[kThreads / 32];
  __shared__ bool s_incl[kThreads / 32];
  __shared__ uint16_t stage[kTile];  // the tile's slots from its first literal on
  __shared__ uint16_t hi_slot[kLean ? kTile : 1];  // the rank-255 literals' slots in the tile
  __shared__ int hist[kLean ? 1 : kBins];
  const int row = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31;
  n = n_rows != nullptr ? n_rows[row] : n;
  ranks += static_cast<size_t>(row) * N;
  status += static_cast<size_t>(row) * nb;
  syms += static_cast<size_t>(row) * (N + 8);
  freqs += static_cast<size_t>(row) * kBins;
  if (t == 0) {
    s_tile = static_cast<int>(atomicAdd(tickets + row, 1u));
    s_first = kNone;
  }
  if constexpr (!kLean) {
    for (int s = t; s < kBins; s += kThreads) hist[s] = 0;
  }
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile + t * kPer;
  int r[kPer];
  load_ranks(ranks, base, N, r);

  // this thread's segment: every literal and the digits of the runs
  // between its own nonzeros
  int first = kNone, last = -1, hi = 0, emit = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = base + k;
    if (i < n && r[k] != 0) {
      if (last >= 0) {
        emit += num_digits(i - last - 1);
      } else {
        first = i;
      }
      emit += 1;
      last = i;
      hi += r[k] == 255;
    }
  }
  // the tile's nonzero before this thread's (-1: none in the tile) and the
  // tile's first nonzero
  int tile_last;
  const int prev = block_exclusive(last, -1, Max(), sh, &tile_last);
  if (first != kNone && prev < 0) s_first = first;
  // the emit counts with the runs between threads, and the rank-255 counts,
  // in one scan (each below 2^16 in a tile)
  const int own = emit + (first != kNone && prev >= 0 ? num_digits(first - prev - 1) : 0);
  int total;
  const int before = block_exclusive(own | hi << 16, 0, Sum(), sh, &total);
  const Seg agg{s_first, tile_last, total & 0xffff, total >> 16};
  // published at once: the aggregate, or tile 0's inclusive prefix; the
  // look-back's first loads go out now and land during the staging, and
  // those that found a word not yet published go out again half-way
  if (t == 0) {
    st_relaxed(status + tile, tile > 0 ? pack_aggregate(agg, tile * kTile)
                                       : pack_inclusive(combine(start_seg(), agg)));
  }
  Word w0 = tile > 0 ? first_word(status, tile) : kInclusive;

  // While the tiles before publish theirs, each nonzero stages its literal
  // and the digits of the run before it at its slot counted from the
  // tile's first literal; the run before that literal waits for the
  // prefix. The rank-255 literals note their slots in the tile.
  int loc = before & 0xffff;
  int hi_at = before >> 16;  // this thread's first rank-255 literal among the tile's
  int q = prev;              // -1: the tile's first literal comes next
  int runa = 0, runb = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (k == kPer / 2 && w0 == 0) w0 = first_word(status, tile);
    const int i = base + k;
    const bool nz = i < n && r[k] != 0;
    if (nz) {
      const int run = i - q - 1;
      const int d = q >= 0 ? num_digits(run) : 0;
      for (int j = 0; j < d; ++j) {
        const int digit = ((run + 1) >> j) & 1;
        stage[loc + j] = static_cast<uint16_t>(digit);
        runb += digit;
      }
      runa += d;
      stage[loc + d] = static_cast<uint16_t>(r[k] + 1);
      if constexpr (kLean) {
        if (r[k] == 255) hi_slot[hi_at++] = static_cast<uint16_t>(loc + d);
      }
      loc += d + 1;
      q = i;
    }
    if constexpr (!kLean) {
      // one shared atomic a literal: on an H100 this beat aggregating the
      // warp's equal literals with __match_any_sync (PERF.md, the RLE2 redesign)
      if (nz && r[k] + 1 < kBins) atomicAdd(&hist[r[k] + 1], 1);
    }
  }
  if constexpr (!kLean) {
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
  }

  Seg before_tile = start_seg();
  if (tile > 0) {  // the same in every thread
    before_tile = look_back(status, tile, w0, s_warp, s_incl);
    if (t == 0) st_relaxed(status + tile, pack_inclusive(combine(before_tile, agg)));
  }
  if (t == 0) s_prefix = before_tile;
  __syncthreads();
  const Seg p = s_prefix;

  // the digits of the run before the tile's first literal at the tile's
  // first slot, p.emit, then the staged slots, consecutive threads on
  // consecutive slots
  const int lead = agg.first != kNone ? num_digits(agg.first - p.last - 1) : 0;
  if (t < lead) {
    const int digit = ((agg.first - p.last) >> t) & 1;
    put<kLean>(syms, lean, p.emit + t, digit);
    if constexpr (!kLean) atomicAdd(&hist[digit], 1);
  }
  const int at = p.emit + lead;
  for (int j = t; j < agg.emit; j += kThreads) put<kLean>(syms, lean, at + j, stage[j]);
  if constexpr (kLean) {
    for (int j = t; j < agg.hi && p.hi + j < kHiCap; j += kThreads) {
      lean.hi_pos[p.hi + j] = at + hi_slot[j];
    }
  } else {
    __syncthreads();  // the lead digits are counted
    for (int s = t; s < kBins; s += kThreads) {
      if (hist[s]) add_count(freqs + s, hist[s]);
    }
  }

  // the row's last tile: the trailing run's digits, the EOB, the length
  if (tile == nb - 1) {
    const Seg f = combine(p, agg);
    const int tail = n - 1 - f.last;
    const int digits = num_digits(tail);
    const int len = f.emit + digits + 1;
    int end;
    if (eob.used != nullptr) {
      end = __syncthreads_count(t < 256 && eob.used[t]) + 1;
    } else if (eob.i64 != nullptr) {
      end = static_cast<int>(*eob.i64);
    } else if (eob.i32 != nullptr) {
      end = eob.i32[row];
    } else {
      end = eob.value;
    }
    if (t < digits) {
      const int digit = ((tail + 1) >> t) & 1;
      put<kLean>(syms, lean, f.emit + t, digit);
      if constexpr (!kLean) add_count(freqs + digit, 1);
    }
    if (t == 0) {
      put<kLean>(syms, lean, len - 1, end);
      rle2_len[row] = static_cast<L>(len);
      if constexpr (!kLean) add_count(freqs + end, 1);
    }
    if constexpr (kLean) {
      for (int k = min(f.hi, kHiCap) + t; k < kHiCap; k += kThreads) lean.hi_pos[k] = kHiNone;
      if (t == 0) *lean.hi_count = f.hi;
    }
  }
}

__host__ __device__ constexpr int tiles_of(int N) {
  return N > kTile ? (N + kTile - 1) / kTile : 1;
}

// The memset of [zero, zero + zero_bytes), which must hold the status
// words (B * tiles_of(N) words at scratch), the tickets (B unsigned after
// them), syms, freqs and the lean byte stream, then the kernel over B rows
// of N ranks. *launched gets the launches enqueued.
template <bool kLean, typename L, typename F>
int enqueue_rle2(const int32_t* ranks, int n, const int32_t* n_rows, int B, int N, Eob eob,
                 void* scratch, uint16_t* syms, L* rle2_len, F* freqs, Lean lean, void* zero,
                 long long zero_bytes, int* launched, cudaStream_t st) {
  *launched = 0;
  if (N < 0 || N + 8 >= kMaxOut || B < 1 || B > 65535 || zero_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = tiles_of(N);
  if (zero_bytes > 0) {
    if (cudaError_t e = cudaMemsetAsync(zero, 0, static_cast<size_t>(zero_bytes), st)) {
      return static_cast<int>(e);
    }
    ++*launched;
  }
  auto* status = static_cast<Word*>(scratch);
  auto* tickets = reinterpret_cast<unsigned*>(status + static_cast<size_t>(B) * nb);
  rle2_onepass<kLean><<<dim3(nb, B), kThreads, 0, st>>>(ranks, n, n_rows, N, nb, eob, status,
                                                         tickets, syms, rle2_len, freqs, lean);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  ++*launched;
  return 0;
}

}  // namespace

// ranks: device int32[N], 16-byte aligned, the first n valid; N + 8 < 2^20.
// The EOB: the used map's count + 1 where used (device bool[256]) is
// given, else *eob64 (device int64 scalar) or *eob32 (device int32
// scalar) where given, else eob_value. scratch: 8 * tiles + 4 bytes, tiles
// = max(1, ceil(N / 4096)). syms: device uint16[N + 8]; rle2_len: device
// int64 scalar; freqs: device int64[258]. [zero, zero + zero_bytes) is
// cleared first and must hold scratch, syms and freqs. Enqueues the memset
// and the kernel on `stream`, *launched their count, and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int tpubz_rle2(const void* ranks, int n, int N, int eob_value, const void* eob64,
                          const void* eob32, const void* used, void* scratch, void* syms,
                          void* rle2_len, void* freqs, void* zero, long long zero_bytes,
                          int* launched, void* stream) {
  if (n < 0 || n > N) return static_cast<int>(cudaErrorInvalidValue);
  const Eob eob{static_cast<const bool*>(used), static_cast<const int64_t*>(eob64),
                static_cast<const int32_t*>(eob32), eob_value};
  return enqueue_rle2<false>(static_cast<const int32_t*>(ranks), n, nullptr, 1, N, eob, scratch,
                             static_cast<uint16_t*>(syms), static_cast<int64_t*>(rle2_len),
                             static_cast<int64_t*>(freqs), Lean{}, zero, zero_bytes, launched,
                             static_cast<cudaStream_t>(stream));
}

// RLE2 of B rows at once: row b's ranks at ranks[b * N :] (N a multiple of
// 4, 16-byte aligned, N + 8 < 2^20), its first n_rows[b] valid (device
// int32[B]), its EOB eob[b] (device int32[B]). scratch: B * (8 * tiles + 4)
// bytes, the status words of every row, then the tickets. syms: device
// uint16[B, N + 8]; rle2_len: device int32[B]; freqs: device int32[B, 258].
// [zero, zero + zero_bytes) as tpubz_rle2's. Each row equals tpubz_rle2 of
// that row. Returns as tpubz_rle2.
extern "C" int tpubz_rle2_batch(const void* ranks, const void* n_rows, int B, int N,
                                const void* eob, void* scratch, void* syms, void* rle2_len,
                                void* freqs, void* zero, long long zero_bytes, int* launched,
                                void* stream) {
  if (N % 4) return static_cast<int>(cudaErrorInvalidValue);
  const Eob e{nullptr, nullptr, static_cast<const int32_t*>(eob), 0};
  return enqueue_rle2<false>(static_cast<const int32_t*>(ranks), 0,
                             static_cast<const int32_t*>(n_rows), B, N, e, scratch,
                             static_cast<uint16_t*>(syms), static_cast<int32_t*>(rle2_len),
                             static_cast<int32_t*>(freqs), Lean{}, zero, zero_bytes, launched,
                             static_cast<cudaStream_t>(stream));
}

// The lean call: RLE2 of one block without frequencies, with the u8
// stream and the slots of its symbols 256. ranks, n, N, scratch as
// tpubz_rle2; used: device bool[256], the EOB its count + 1. syms: device
// uint16[N + 8]; rle2_len: device int64 scalar; u8: device uint8[N + 8];
// hi_pos: device int32[8192]; hi_count: device int32 scalar. [zero, zero +
// zero_bytes) is cleared first and must hold scratch, syms and u8. Returns
// as tpubz_rle2.
extern "C" int tpubz_rle2_compact(const void* ranks, int n, int N, const void* used,
                                  void* scratch, void* syms, void* rle2_len, void* u8,
                                  void* hi_pos, void* hi_count, void* zero, long long zero_bytes,
                                  int* launched, void* stream) {
  if (n < 0 || n > N || used == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Lean lean{static_cast<uint8_t*>(u8), static_cast<int32_t*>(hi_pos),
                  static_cast<int32_t*>(hi_count)};
  const Eob eob{static_cast<const bool*>(used), nullptr, nullptr, 0};
  return enqueue_rle2<true>(static_cast<const int32_t*>(ranks), n, nullptr, 1, N, eob, scratch,
                            static_cast<uint16_t*>(syms), static_cast<int64_t*>(rle2_len),
                            static_cast<int64_t*>(nullptr), lean, zero, zero_bytes, launched,
                            static_cast<cudaStream_t>(stream));
}

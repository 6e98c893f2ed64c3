// The inverse BWT on the card: the next-pointer vector by a stable counting
// sort, and the key's orbit by list ranking over sampled splitters, each one
// library call.
//
// Replaces tpubz/kernels/ibwt.py:_next_pointers (a stable (byte, position)
// sort of the last column, lanes >= n as byte 256) and bwt_inverse_device
// (the orbit of the key in ceil(log2 n) pointer-doubling steps, each a jit
// call of its own driven from the host: "TPU has no fast random gather").
// Its outputs, bit for bit: nxt[j] = the position in `last` of the j-th
// entry in (byte, position) order, so nxt[n:] = n..N-1; the inverse
// out[i] = last[p_i], p_0 = nxt[key], p_{i+1} = nxt[p_i].
//
// The next pointers (one call):
//   a memset  of the zeroed words (the sort's histogram, ticket and status
//             words, the orbit's record and ticket);
//   ibwt_keys one CTA per tile of 4096 positions: key (byte << 20) | i of
//             each position below n, and the CTA's byte counts added to the
//             sort's histogram (csrc/radix.cuh hist_add);
//   radix_pass csrc/radix.cuh's onesweep pass over bits [20, 28): one 8-bit
//             digit, stable, so equal bytes keep position order;
//   ibwt_nxt  nxt[j] = the low 20 bits of sorted key j below n, j above.
// The inverse runs the memset, the keys and the pass, and its walks read the
// sorted keys themselves: row u's is last[nxt[u]] << 20 | nxt[u], the next
// row and its byte in one 8-byte gather.
//
// The orbit in O(n) (four launches). p_0's sequence is a walk around the
// cycle of nxt that holds p_0 (its length L is n unless the block is
// periodic: tied rotations split nxt into cycles). Splitters cut the cycles
// into segments that threads walk at once, three levels deep:
//   level 1   the rows: window w of 2^kLog1 rows has one splitter, the row
//             w * 2^kLog1 + pick(w), pick the top bits of a Fibonacci hash
//             of w (a fixed rule per window, so that no period of the
//             block lines up with it, as an every-d-th-row rule can); p_0
//             is a splitter too, in a slot past the windows when its window
//             picked another row. A row is a splitter when it is its
//             window's pick or p_0: two compares, no table.
//   walk_rows one thread a splitter walks to the next splitter, one gather
//             a row, keeping its segment's first kBuffered bytes (a word
//             store every four rows, into its own slot) and the row it
//             reached there; then writes its segment's length and successor
//             (a level-1 node; the successor word marks the level-2
//             splitters). A walk ends at a splitter: at worst its own
//             start, after its cycle's length.
//   walk_list one thread a level-2 splitter (one a window of 2^kLog2 nodes,
//             and p_0's node) walks the level-1 nodes likewise, writing each
//             node's (level-2 slot, rows before it there).
//   rank_top  one CTA: the level-2 nodes in shared memory, walked there from
//             the level-3 splitters (one a window of 2^kLog3, and p_0's),
//             the level-3 list cut before p_0's node and ranked by pointer
//             doubling in shared memory (at most 2,050 nodes at n = 2^20):
//             each level-2 node's offset in the orbit (or -1 off p_0's
//             cycle), and L.
//   write_orbit one thread a level-1 segment of p_0's cycle copies its kept
//             bytes to its offset (its level-2 segment's, plus the rows
//             before it there), stored four at a time (byte by byte at the
//             segment's ends, whose words other segments share), and walks
//             on from the row it reached when the segment is longer;
//             segments on other cycles, and cycles no walk reached, write
//             nothing. Its last CTA by ticket fills out[i] = out[i mod L]
//             for i >= L when L < n, and copies the call's record to the
//             caller's pinned words.
// Launches a call: seven (the memset, the keys, the pass and the orbit's
// four, which count their own launches on the card).
//
// What bounds it on an H100: the next pointers read n bytes and write 4N
// (1.3 us at level 9 at 3.35 TB/s); any inverse reads n bytes and writes n
// (0.54 us). This formulation's bytes: the sort's (the column, keys 8n
// written, one pass 16n), one 8-byte gather a row, the kept bytes written
// and read (2n), the column's bytes at the splitters, 24 bytes a level-1
// node and 12 a level-2 node, the n bytes written: ~38 bytes a row, 10 us at
// level 9 as HBM traffic, though the ~20 MB of arrays stay in the 50 MB L2.
// The walks are chains of dependent L2 loads: the longest level-1 and
// level-2 walks (about d ln(n / d) steps at density 1/d) times the L2's
// latency bound the call, not its bytes.
#include <cuda_runtime.h>

#include <cstdint>

#include "radix.cuh"


namespace tpubz {
namespace radix {
namespace {  // the header's: one internal namespace in this source

constexpr int kPosBits = 20;  // a position below 2^20 (radix.cuh's kMaxLog2)
constexpr uint32_t kPosMask = (1u << kPosBits) - 1;
constexpr int kRoundThreads = 256;
// log2 of the splitter windows, the fastest of the densities ibwt_probe
// measures: rows a level-1 window, level-1 nodes a level-2 window, nodes a
// window of the top's levels 3 and 4
constexpr int kLog1 = 3;
constexpr int kLog2 = 3;
constexpr int kLog3 = 3;
static_assert(kLog1 >= 1 && kLog2 >= 1 && kLog3 >= 1, "a window holds two or more");
constexpr uint32_t kMark = 1u << 31;      // a node word's successor is a splitter
constexpr uint32_t kNone = 0xffffffffu;   // a slot whose window has no splitter
constexpr uint32_t kVisited = 1u << 30;   // bits 31-30 = 01: a top walk passed the node
constexpr uint32_t kNil = 0x7fffffffu;    // the end of the top's list
constexpr int kBuffered = 64;  // the bytes of a level-1 segment its first walk keeps
constexpr int kWalkThreads = 256;
constexpr int kTopThreads = 1024;
constexpr int kWriteThreads = 256;
constexpr int kFillShared = 16384;  // the period the fill keeps in shared memory
// the most slots of levels 2, 3 and 4 (n <= 2^20)
constexpr int kMaxLevel2 = ((((1 << kPosBits) >> kLog1) + 1 + (1 << kLog2) - 1) >> kLog2) + 1;
constexpr int kMaxLevel3 = ((kMaxLevel2 + (1 << kLog3) - 1) >> kLog3) + 1;
constexpr int kMaxLevel4 = ((kMaxLevel3 + (1 << kLog3) - 1) >> kLog3) + 1;
constexpr int kMaxTopBytes = 8 * kMaxLevel2 + 12 * kMaxLevel3 + 12 * kMaxLevel4;
static_assert(kMaxTopBytes <= 227 * 1024, "the top's nodes fit one CTA's shared memory");
static_assert(kMaxLevel4 <= kTopThreads, "the doubling takes a level-4 node a thread");

// the record of an inverse call, in device words then the caller's pinned
// words: the orbit's kernel launches (counted on the card), level-1
// splitters that walked, level-1 segments on p_0's cycle, the longest
// level-1 walk (rows), L, level-2 splitters that walked, the longest level-2
// walk (level-1 nodes), the top's walks (levels 3 and 4)
enum { kRecLaunches, kRecSplitters, kRecSegments, kRecLongest, kRecOrbit, kRecListSplitters,
       kRecListLongest, kRecTopSplitters, kRecWords };
constexpr int kOrbitWords = kRecWords + 1;  // the record, then write_orbit's ticket
constexpr int kOrbitKernels = 4;

// The offset of window w's splitter in its window of 2^log.
__device__ __forceinline__ uint32_t pick(uint32_t w, int log) {
  return (w * 0x9E3779B1u) >> (32 - log);
}

__device__ __forceinline__ bool picked(uint32_t x, int log) {
  return (x & ((1u << log) - 1)) == pick(x >> log, log);
}

// The slot of splitter x one level up: its window's, or the start's own
// slot past the windows when the start is not its window's pick.
__device__ __forceinline__ uint32_t slot_of(uint32_t x, uint32_t start, int log,
                                            uint32_t windows) {
  return x == start && !picked(x, log) ? windows : x >> log;
}

// The windows and slots of each level for n rows.
struct Levels {
  uint32_t w1, m1, w2, m2, w3, m3, w4, m4;
  __host__ __device__ explicit Levels(int n) {
    w1 = (static_cast<uint32_t>(n) + (1u << kLog1) - 1) >> kLog1;
    m1 = w1 + 1;
    w2 = (m1 + (1u << kLog2) - 1) >> kLog2;
    m2 = w2 + 1;
    w3 = (m2 + (1u << kLog3) - 1) >> kLog3;
    m3 = w3 + 1;
    w4 = (m3 + (1u << kLog3) - 1) >> kLog3;
    m4 = w4 + 1;
  }
  __host__ __device__ size_t top_bytes() const {
    return 8 * size_t{m2} + 12 * size_t{m3} + 12 * size_t{m4};
  }
};

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
  if (j < N) nxt[j] = j < n ? static_cast<int32_t>(sorted[j] & kPosMask) : j;
}

// Adds the CTA's sum of `add` and its largest `most` to rec[at_add] and
// rec[at_most] (at_most < 0: none), one global atomic each. Every thread of
// the CTA calls it; s: two shared words.
__device__ __forceinline__ void cta_count(unsigned add, unsigned most, int* rec, int at_add,
                                          int at_most, unsigned* s) {
  add = __reduce_add_sync(kFull, add);
  most = __reduce_max_sync(kFull, most);
  if (threadIdx.x == 0) s[0] = s[1] = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && add) {
    atomicAdd(s, add);
    atomicMax(s + 1, most);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s[0]) {
    atomicAdd(rec + at_add, static_cast<int>(s[0]));
    if (at_most >= 0) atomicMax(rec + at_most, static_cast<int>(s[1]));
  }
}

// The row a level-1 slot's walk starts from, and whether the slot has one.
__device__ __forceinline__ bool slot_row(uint32_t w, uint32_t p0, const Levels& lv, int n,
                                         uint32_t* row) {
  if (w < lv.w1) {
    *row = (w << kLog1) + pick(w, kLog1);
    return *row < static_cast<uint32_t>(n);
  }
  *row = p0;
  return !picked(p0, kLog1);
}

// Level 1: one thread a slot (window or p_0's) walks rows to the next
// splitter, one 8-byte gather a step: the sorted key of row u is
// last[nxt[u]] << 20 | nxt[u], the next row and its byte at once, and the
// next row is a splitter when it is its window's pick or p_0. The walk keeps
// its segment's first kBuffered bytes in its slot of `bytes`, a word at a
// time, and the row it reached there in `resume`; it writes its segment's
// length and successor (a level-1 node, kMark when that is a level-2
// splitter).
__global__ void __launch_bounds__(kWalkThreads)
    walk_rows(const int64_t* __restrict__ sorted, const uint8_t* __restrict__ last, int n,
              int key, uint2* __restrict__ node1, int2* __restrict__ rec1,
              uint8_t* __restrict__ bytes, uint32_t* __restrict__ resume, int* rec) {
  __shared__ unsigned s_count[2];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(rec + kRecLaunches, 1);
  const Levels lv(n);
  const uint32_t w = blockIdx.x * kWalkThreads + threadIdx.x;
  const uint32_t p0 = static_cast<uint32_t>(__ldg(sorted + key)) & kPosMask;
  const uint32_t k0 = slot_of(p0, p0, kLog1, lv.w1);
  unsigned len = 0;
  uint32_t u;
  if (w < lv.m1) {
    rec1[w] = make_int2(-1, 0);
    uint2 node = make_uint2(kNone, 0);
    if (slot_row(w, p0, lv, n, &u)) {
      auto* mine = reinterpret_cast<uint32_t*>(bytes + static_cast<size_t>(w) * kBuffered);
      uint32_t b = last[u], acc = 0, t;
      while (true) {
        if (len < kBuffered) {
          acc |= b << (8 * (len & 3));
          if ((len & 3) == 3) {
            mine[len >> 2] = acc;
            acc = 0;
          }
        }
        const uint32_t word = static_cast<uint32_t>(__ldg(sorted + u));
        t = word & kPosMask;
        ++len;
        if (t == p0 || picked(t, kLog1)) break;
        u = t;
        b = (word >> kPosBits) & 0xff;
        if (len == kBuffered) resume[w] = u;
      }
      if ((len & 3) && len <= kBuffered) mine[len >> 2] = acc;
      const uint32_t s = slot_of(t, p0, kLog1, lv.w1);
      node = make_uint2(s | (picked(s, kLog2) || s == k0 ? kMark : 0u), len);
    }
    node1[w] = node;
  }
  cta_count(len > 0, len, rec, kRecSplitters, kRecLongest, s_count);
}

// Level 2: one thread a slot (window of level-1 nodes, or p_0's node) walks
// the level-1 nodes to the next level-2 splitter, writing each node's
// (level-2 slot, rows before it) and its segment's successor and rows.
__global__ void __launch_bounds__(kWalkThreads)
    walk_list(const int64_t* __restrict__ sorted, int n, int key,
              const uint2* __restrict__ node1, int2* __restrict__ rec1,
              uint2* __restrict__ node2, int* rec) {
  __shared__ unsigned s_count[2];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(rec + kRecLaunches, 1);
  const Levels lv(n);
  const uint32_t p0 = static_cast<uint32_t>(__ldg(sorted + key)) & kPosMask;
  const uint32_t k0 = slot_of(p0, p0, kLog1, lv.w1);
  const uint32_t j0 = slot_of(k0, k0, kLog2, lv.w2);
  const uint32_t j = blockIdx.x * kWalkThreads + threadIdx.x;
  unsigned nodes = 0;
  if (j < lv.m2) {
    uint32_t u = k0;
    bool used = !picked(k0, kLog2);
    if (j < lv.w2) {
      u = (j << kLog2) + pick(j, kLog2);
      used = u < lv.m1 && __ldg(&node1[u].y) > 0;
    }
    uint2 node = make_uint2(kNone, 0);
    if (used) {
      uint32_t rows = 0;
      uint2 e;
      do {
        rec1[u] = make_int2(static_cast<int>(j), static_cast<int>(rows));
        e = __ldg(node1 + u);
        rows += e.y;
        ++nodes;
        u = e.x & ~kMark;
      } while (!(e.x & kMark));
      const uint32_t s = slot_of(u, k0, kLog2, lv.w2);
      node = make_uint2(s | (picked(s, kLog3) || s == j0 ? kMark : 0u), rows);
    }
    node2[j] = node;
  }
  cta_count(nodes > 0, nodes, rec, kRecListSplitters, kRecListLongest, s_count);
}

// One level of walks in the top's shared memory. The walkers (one a window
// of 2^kLog3 of the m nodes below, and `start`'s slot past the windows)
// walk those nodes, rewriting each in place as (slot | kVisited, rows
// before it in the slot's segment), and write their own nodes above:
// (successor slot, kMark when it is a splitter one level up, rows); at the
// last level the walk that ends at the start's slot is cut (kNil), and a
// slot with no splitter is a loop of no rows, which never reaches the end.
// Returns the walks this thread made.
__device__ uint32_t walk_shared(uint2* below, uint32_t m, uint32_t start, uint2* above,
                                bool last) {
  const uint32_t windows = (m + (1u << kLog3) - 1) >> kLog3;
  const uint32_t s0 = slot_of(start, start, kLog3, windows);
  uint32_t walks = 0;
  for (uint32_t i = threadIdx.x; i <= windows; i += blockDim.x) {
    uint32_t u = start;
    bool used = !picked(start, kLog3);
    if (i < windows) {
      u = (i << kLog3) + pick(i, kLog3);
      used = u < m && below[u].y > 0;
    }
    uint2 node = make_uint2(last ? i : kNone, 0);
    if (used) {
      uint32_t rows = 0;
      uint2 e;
      do {
        e = below[u];
        below[u] = make_uint2(i | kVisited, rows);  // only this walk reads node u
        rows += e.y;
        u = e.x & ~kMark;
      } while (!(e.x & kMark));
      const uint32_t s = slot_of(u, start, kLog3, windows);
      node = last ? make_uint2(s == s0 ? kNil : s, rows)
                  : make_uint2(s | (picked(s, kLog3) || s == s0 ? kMark : 0u), rows);
      ++walks;
    }
    above[i] = node;
  }
  return walks;
}

// The offset of each node below from its record and the offsets above
// (-1 for a node that no walk passed or whose segment is off p_0's cycle).
__device__ __forceinline__ int offset_of(uint2 e, const int* above) {
  return (e.x >> 30) == 1 && above[e.x & ~kVisited] >= 0
             ? above[e.x & ~kVisited] + static_cast<int>(e.y)
             : -1;
}

// The top, one CTA: the level-2 nodes in shared memory, walked there from
// the level-3 splitters, the level-3 nodes from the level-4 splitters (one
// a window of 2^kLog3 each, and p_0's node), the level-4 list cut before
// p_0's node and ranked by pointer doubling, one node a thread; then the
// offsets down the levels: each level-2 node's offset in the orbit (-1 off
// p_0's cycle), and L.
__global__ void __launch_bounds__(kTopThreads)
    rank_top(const int64_t* __restrict__ sorted, int n, int key, const uint2* __restrict__ node2,
             int32_t* __restrict__ off2, int* rec) {
  extern __shared__ uint4 sh4[];
  if (threadIdx.x == 0) atomicAdd(rec + kRecLaunches, 1);
  const Levels lv(n);
  const uint32_t p0 = static_cast<uint32_t>(__ldg(sorted + key)) & kPosMask;
  const uint32_t k0 = slot_of(p0, p0, kLog1, lv.w1);
  const uint32_t j0 = slot_of(k0, k0, kLog2, lv.w2);
  const uint32_t i0 = slot_of(j0, j0, kLog3, lv.w3);
  const uint32_t h0 = slot_of(i0, i0, kLog3, lv.w4);
  auto* lvl2 = reinterpret_cast<uint2*>(sh4);  // m2: (succ | mark, rows), then the records
  uint2* lvl3 = lvl2 + lv.m2;                  // m3: the same
  uint2* lvl4 = lvl3 + lv.m3;                  // m4: (succ, rows), then (next, to the end)
  int* off3 = reinterpret_cast<int*>(lvl4 + lv.m4);
  int* off4 = off3 + lv.m3;
  const uint32_t pairs = (lv.m2 + 1) >> 1;  // 16-byte loads: the buffer is 256-byte aligned
#pragma unroll 8
  for (uint32_t q = threadIdx.x; q < pairs; q += blockDim.x) {
    sh4[q] = __ldg(reinterpret_cast<const uint4*>(node2) + q);
  }
  __syncthreads();
  unsigned walks = walk_shared(lvl2, lv.m2, j0, lvl3, false);
  __syncthreads();
  walks += walk_shared(lvl3, lv.m3, i0, lvl4, true);
  __syncthreads();
  // pointer doubling: after ceil(log2 m4) rounds every node of p_0's list
  // points to kNil with its rows to the end of the list
  const int rounds = 32 - __clz(static_cast<int>(lv.m4));
  const uint32_t i = threadIdx.x;
  for (int r = 0; r < rounds; ++r) {
    uint2 a = i < lv.m4 ? lvl4[i] : make_uint2(kNil, 0);
    if (a.x != kNil) {
      const uint2 b = lvl4[a.x];
      a = make_uint2(b.x, a.y + b.y);
    }
    __syncthreads();
    if (i < lv.m4) lvl4[i] = a;
    __syncthreads();
  }
  const uint32_t orbit = lvl4[h0].y;  // p_0's node to the cut: the whole cycle
  if (i < lv.m4) off4[i] = lvl4[i].x == kNil ? static_cast<int>(orbit - lvl4[i].y) : -1;
  __syncthreads();
  for (uint32_t q = threadIdx.x; q < lv.m3; q += blockDim.x) off3[q] = offset_of(lvl3[q], off4);
  __syncthreads();
#pragma unroll 4
  for (uint32_t q = threadIdx.x; q < lv.m2; q += blockDim.x) off2[q] = offset_of(lvl2[q], off3);
  walks = __reduce_add_sync(kFull, walks);
  if ((threadIdx.x & 31) == 0 && walks) atomicAdd(rec + kRecTopSplitters, static_cast<int>(walks));
  if (threadIdx.x == 0) rec[kRecOrbit] = static_cast<int>(orbit);
}

// One thread a level-1 segment of p_0's cycle writes the 4-byte words of
// the orbit that start inside its segment, at its offset (its level-2
// segment's, plus the rows before it there): its kept bytes, then, for a
// segment longer than kBuffered, a walk on from the row its first walk
// reached, and for the last word the first bytes of the segments after it
// (their kept bytes). Every word is stored whole by one thread, but the
// last of the block when n is no multiple of 4, whose bytes past n are not
// stored. Segments on other cycles, and cycles no walk reached, write
// nothing. The last CTA fills the periods past L and copies the record to
// the caller's pinned words.
__global__ void __launch_bounds__(kWriteThreads)
    write_orbit(const int64_t* __restrict__ sorted, const uint8_t* __restrict__ last, int n,
                const uint2* __restrict__ node1, const int2* __restrict__ rec1,
                const int32_t* __restrict__ off2, const uint8_t* __restrict__ bytes,
                const uint32_t* __restrict__ resume, uint8_t* out, int* rec, unsigned* ticket,
                int* pinned) {
  __shared__ uint8_t s_period[kFillShared];
  __shared__ unsigned s_count[2];
  __shared__ bool s_last;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(rec + kRecLaunches, 1);
  const Levels lv(n);
  const uint32_t w = blockIdx.x * kWriteThreads + threadIdx.x;
  unsigned mine = 0;
  if (w < lv.m1) {
    const uint2 node = __ldg(node1 + w);
    const int2 e = rec1[w];
    const int off = node.y > 0 && e.x >= 0 ? off2[e.x] : -1;
    if (off >= 0) {
      const uint32_t len = node.y, o = static_cast<uint32_t>(off + e.y);
      const uint32_t* kept = reinterpret_cast<const uint32_t*>(bytes) + w * (kBuffered / 4);
      uint32_t acc = 0, word = 0, u = 0;
      uint32_t next = node.x & ~kMark, next_len = 0, j = 0;  // the segments after this one
      for (uint32_t k = ((o + 3) & ~3u) - o; o + k < ((o + len + 3) & ~3u); ++k) {
        uint32_t b;
        if (k < len) {
          if (k < kBuffered) {
            if ((k & 3) == 0 || k < 4) word = __ldg(kept + (k >> 2));
            b = (word >> (8 * (k & 3))) & 0xff;
          } else if (k == kBuffered) {
            u = resume[w];
            b = last[u];
          } else {
            const uint32_t x = static_cast<uint32_t>(__ldg(sorted + u));
            u = x & kPosMask;
            b = (x >> kPosBits) & 0xff;
          }
        } else {
          if (next_len == 0) next_len = __ldg(&node1[next].y);
          while (j >= next_len) {  // a segment shorter than the bytes wanted
            j -= next_len;
            next = __ldg(&node1[next].x) & ~kMark;
            next_len = __ldg(&node1[next].y);
          }
          b = __ldg(bytes + static_cast<size_t>(next) * kBuffered + j++);
        }
        const uint32_t pos = o + k;
        acc |= b << (8 * (pos & 3));
        if ((pos & 3) == 3) {
          if (pos < static_cast<uint32_t>(n)) {
            *reinterpret_cast<uint32_t*>(out + pos - 3) = acc;
          } else {
            for (uint32_t p = pos - 3; p < static_cast<uint32_t>(n); ++p) {
              out[p] = static_cast<uint8_t>(acc >> (8 * (p & 3)));
            }
          }
          acc = 0;
        }
      }
      mine = 1;
    }
  }
  cta_count(mine, 0, rec, kRecSegments, -1, s_count);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // every CTA's bytes are written before the fill reads them
  const int orbit = __ldcg(rec + kRecOrbit);
  if (orbit < n && orbit <= kFillShared) {
    for (int x = threadIdx.x; x < orbit; x += blockDim.x) s_period[x] = __ldcg(out + x);
    __syncthreads();
    const int head = min(n, (orbit + 15) & ~15);
    for (int i = orbit + threadIdx.x; i < head; i += blockDim.x) out[i] = s_period[i % orbit];
    for (int c = (head >> 4) + threadIdx.x; c < (n >> 4); c += blockDim.x) {
      uint32_t v[4] = {0, 0, 0, 0};
      int x = (c << 4) % orbit;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        v[q >> 2] |= static_cast<uint32_t>(s_period[x]) << (8 * (q & 3));
        x = x + 1 == orbit ? 0 : x + 1;
      }
      reinterpret_cast<uint4*>(out)[c] = make_uint4(v[0], v[1], v[2], v[3]);
    }
    for (int i = max(head, n & ~15) + threadIdx.x; i < n; i += blockDim.x) {
      out[i] = s_period[i % orbit];
    }
  } else if (orbit < n) {
    for (int i = orbit + threadIdx.x; i < n; i += blockDim.x) out[i] = __ldcg(out + i % orbit);
  }
  __syncthreads();
  if (threadIdx.x < kRecWords) pinned[threadIdx.x] = __ldcg(rec + threadIdx.x);
}

constexpr size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

// The scratch: two key buffers, then the words zeroed once per call (the
// histogram, the pass's ticket, the status words, the orbit's record and
// ticket); the inverse's adds the level-1 nodes, their records, kept bytes
// and resume rows, and the level-2 nodes and offsets.
struct Layout {
  size_t keys, sorted, zero, hist, ticket, status, orbit, next_bytes;
  size_t node1, rec1, bytes_kept, resume, node2, off2, bytes;
  explicit Layout(int n) {
    const Levels lv(n);
    keys = 0;
    sorted = align256(8 * static_cast<size_t>(n));
    zero = sorted + align256(8 * static_cast<size_t>(n));
    hist = zero;
    ticket = hist + 4 * kBins;
    status = ticket + 4;
    orbit = status + 4 * static_cast<size_t>(tiles_of(n)) * kBins;
    next_bytes = align256(orbit + 4 * kOrbitWords);
    node1 = next_bytes;
    rec1 = node1 + align256(8 * size_t{lv.m1});
    bytes_kept = rec1 + align256(8 * size_t{lv.m1});
    resume = bytes_kept + align256(size_t{kBuffered} * lv.m1);
    node2 = resume + align256(4 * size_t{lv.m1});
    off2 = node2 + align256(8 * (size_t{lv.m2} + 1));
    bytes = off2 + align256(4 * size_t{lv.m2});
  }
};

// Enqueues the memset, the keys and the pass of last[:n]; adds the kernel
// launches to *launched.
int enqueue_sort(const uint8_t* last, int n, unsigned char* b, const Layout& L, int* launched,
                 cudaStream_t st) {
  if (cudaError_t e = cudaMemsetAsync(b + L.zero, 0, L.next_bytes - L.zero, st)) {
    return static_cast<int>(e);
  }
  auto* keys = reinterpret_cast<int64_t*>(b + L.keys);
  auto* hist = reinterpret_cast<uint32_t*>(b + L.hist);
  ibwt_keys<<<tiles_of(n), kThreads, 0, st>>>(last, n, keys, hist);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  ++*launched;
  int64_t* const bufs[2] = {reinterpret_cast<int64_t*>(b + L.sorted), keys};
  return enqueue_passes(keys, bufs, n, kPosBits, kPosBits + kDigitBits, hist,
                        reinterpret_cast<uint32_t*>(b + L.status),
                        reinterpret_cast<uint32_t*>(b + L.ticket), launched, st);
}

bool sizes_ok(int n, int N) { return n >= 0 && n <= N && n <= (1 << kMaxLog2) && N < (1 << 30); }

}  // namespace
}  // namespace radix
}  // namespace tpubz

using tpubz::radix::Layout;

// sizes[0]: the scratch bytes of the next pointers of n of N bytes;
// sizes[1]: the inverse's; sizes[2]: the pinned int32 words of an inverse's
// record; sizes[3..5]: log2 of the splitter windows of levels 1, 2 and 3;
// sizes[6]: the orbit's kernels a call. Returns cudaErrorInvalidValue for
// sizes the calls do not take, else 0.
extern "C" int tpubz_ibwt_sizes(int n, int N, long long* sizes) {
  using namespace tpubz::radix;
  if (!sizes_ok(n, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(n);
  sizes[0] = static_cast<long long>(L.next_bytes);
  sizes[1] = static_cast<long long>(L.bytes);
  sizes[2] = kRecWords;
  sizes[3] = kLog1;
  sizes[4] = kLog2;
  sizes[5] = kLog3;
  sizes[6] = kOrbitKernels;
  return 0;
}

// last: device uint8[N], the first n the column (n <= 2^20); scratch:
// device memory of sizes[0] bytes, 256-byte aligned; nxt: device
// int32[N]. Enqueues the next pointers on `stream`, writes its kernel
// launches to *launched and returns cudaGetLastError() as an int.
extern "C" int tpubz_next_pointers(const void* last, int n, int N, void* scratch,
                                   long long scratch_bytes, void* nxt, int* launched,
                                   void* stream) {
  using namespace tpubz::radix;
  *launched = 0;
  if (!sizes_ok(n, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(n);
  if (static_cast<size_t>(scratch_bytes) < L.next_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  auto* b = static_cast<unsigned char*>(scratch);
  if (n > 0) {
    if (int rc = enqueue_sort(static_cast<const uint8_t*>(last), n, b, L, launched, st)) {
      return rc;
    }
  }
  if (N > 0) {
    ibwt_nxt<<<(N + kRoundThreads - 1) / kRoundThreads, kRoundThreads, 0, st>>>(
        reinterpret_cast<const int64_t*>(b + L.sorted), n, N, static_cast<int32_t*>(nxt));
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    ++*launched;
  }
  return 0;
}

// The inverse of the BWT (key, last[:n]): last as tpubz_next_pointers,
// 0 <= key < n (any key when n is 0); scratch: sizes[1] bytes, 256-byte
// aligned; pinned: sizes[2] page-locked host words, which the card writes
// the call's record into once it has run (they must live until the stream
// has passed the call); out: device uint8[n], 16-byte aligned. Enqueues the
// next pointers and the orbit's kernels on `stream` (nothing when n is 0);
// *launched gets the kernel launches enqueued. Returns cudaGetLastError()
// (or the error of a runtime call) as an int.
extern "C" int tpubz_bwt_inverse(const void* last, int key, int n, int N, void* scratch,
                                 long long scratch_bytes, int* pinned, void* out, int* launched,
                                 void* stream) {
  using namespace tpubz::radix;
  *launched = 0;
  if (!sizes_ok(n, N) || (n > 0 && (key < 0 || key >= n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L(n);
  if (static_cast<size_t>(scratch_bytes) < L.bytes) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  auto* b = static_cast<unsigned char*>(scratch);
  const auto* col = static_cast<const uint8_t*>(last);
  int* card_pinned = nullptr;
  if (cudaError_t e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&card_pinned), pinned, 0)) {
    return static_cast<int>(e);
  }
  static bool top_ready[64] = {};  // rank_top's shared memory granted, by device
  int device = 0;
  if (cudaError_t e = cudaGetDevice(&device)) return static_cast<int>(e);
  if (device >= 64 || !top_ready[device]) {
    if (cudaError_t e = cudaFuncSetAttribute(
            rank_top, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxTopBytes)) {
      return static_cast<int>(e);
    }
    if (device < 64) top_ready[device] = true;  // a race sets it twice, to the same
  }
  if (int rc = enqueue_sort(col, n, b, L, launched, st)) return rc;
  const auto* sorted = reinterpret_cast<const int64_t*>(b + L.sorted);
  auto* node1 = reinterpret_cast<uint2*>(b + L.node1);
  auto* rec1 = reinterpret_cast<int2*>(b + L.rec1);
  auto* kept = b + L.bytes_kept;
  auto* resume = reinterpret_cast<uint32_t*>(b + L.resume);
  auto* node2 = reinterpret_cast<uint2*>(b + L.node2);
  auto* off2 = reinterpret_cast<int32_t*>(b + L.off2);
  auto* rec = reinterpret_cast<int*>(b + L.orbit);
  auto* ticket = reinterpret_cast<unsigned*>(rec + kRecWords);
  const tpubz::radix::Levels lv(n);
  walk_rows<<<(lv.m1 + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0, st>>>(
      sorted, col, n, key, node1, rec1, kept, resume, rec);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  ++*launched;
  walk_list<<<(lv.m2 + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0, st>>>(
      sorted, n, key, node1, rec1, node2, rec);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  ++*launched;
  rank_top<<<1, kTopThreads, lv.top_bytes(), st>>>(sorted, n, key, node2, off2, rec);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  ++*launched;
  write_orbit<<<(lv.m1 + kWriteThreads - 1) / kWriteThreads, kWriteThreads, 0, st>>>(
      sorted, col, n, node1, rec1, off2, kept, resume, static_cast<uint8_t*>(out), rec, ticket,
      card_pinned);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  ++*launched;
  return 0;
}

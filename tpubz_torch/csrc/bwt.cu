// The whole forward BWT of one block on the card, in one library call:
// every doubling round (keys, their sort, re-rank and compaction), the stop
// test, the key and the last column.
//
// Replaces tpubz/kernels/suffix_sort.py:bwt_forward, an XLA program of
// tpubz's device chain (a fixed number of 4-key variadic sorts under
// lax.cond, shifts by concatenation, a cumsum of difference flags and a
// second sort for the last column: a TPU has no fast gather or scatter).
// Only its outputs are kept: key = the number of rotations strictly smaller
// than rotation 0, last[:n] = the BWT last column (periodic blocks
// included), last[n:] = 0. The formulation is this card's
// (tpubz_torch/kernels/suffix_sort.py describes it): prefix doubling with
// group-start ranks that sorts, after round 0, only the rotations whose
// class still has company, one int64 key a rotation with its position in
// bits 0-19.
//
// A round's active rotations come in two lists, each in class order: the
// members of classes larger than kSmallTile (4096) keys, and the rest.
// Sorting a round never moves a key out of its class's range, so the
// round's sorted array is the large list sorted, then the small list
// sorted, each class in place; the re-rank needs no other order.
//
//   bwt_keys          the large list's keys, built straight into the radix
//                     sort's histogram launch: round 0 from the block's
//                     bytes (all n rotations, one class), a later round
//                     from the list and rank (rank[i] << 40 |
//                     rank[(i + h) mod n] << 20 | i).
//   bwt_pass          one launch a digit of bits 20-59 over the large list
//                     (csrc/radix.cuh's onesweep pass); a pass whose digit
//                     histogram puts every key in one bin is skipped, so
//                     the buffer that holds the keys after each pass is a
//                     device word (sel).
//   bwt_small_sort    one CTA a chunk of the small list: the classes that
//                     start within a window of kSmallTile list entries
//                     (fewer than 2 * kSmallTile keys), their keys built,
//                     then sorted in shared memory by (class, bits 20-39)
//                     in four stable LSD passes, or, when no class of the
//                     chunk has more than 64 keys, each key placed by the
//                     count of its class's keys that go before it; written
//                     after the large list's sorted keys.
//   bwt_rank_tiles    one CTA per tile of 2048 sorted keys: its last class
//                     start, its first and last head, its heads, class
//                     starts and rotations that stay active.
//   bwt_rank_scan     one CTA a row: the tiles' aggregates scanned, per
//                     tile the heads around it and the large and small
//                     members of the new classes before it (only classes
//                     that cross a tile's edges can be large), the large
//                     classes that start before it; the round's state.
//   bwt_rank_apply    one CTA per tile, from its scan: key q's slot is
//                     g + q - (its class's first index), its rank its
//                     head's slot, its new class's size the distance to the
//                     next head. rank[i], sa[slot] and the next round's two
//                     lists are written (sa and the lists through shared
//                     memory, in tile order), with the rank of each large
//                     class by ordinal and the first class start of each
//                     window of the small list.
//   bwt_round_end     one warp, a lane a row: each row's rounds, active
//                     rotations, stop or cap error, the round counter, and
//                     whether the loop runs again.
//   bwt_last_column   last[p] = block[(sa[p] + n - 1) mod n], key = rank[0]:
//                     one gather, ties included (identical rotations).
//
// The rounds run on the card. One CUDA graph per (stream, rows, N) holds a
// conditional WHILE node whose body is one doubling round over every row;
// bwt_round_end sets its condition, so the host enqueues a call as a memset,
// a setup launch (the call's pointers and lengths, by value, into the
// graph's own parameter block, which every kernel of the body reads), the
// graph and the last column, and returns without waiting. Every kernel
// reads the round from a device word and derives its shift, tags, buffers
// and gate from it; a row that stopped, or takes no round, leaves every
// launch at once. The graph's parameter block is shared by the calls on its
// stream, which the stream orders, and a lock keeps one host thread's setup
// and graph launch together. Each row's record (rounds, active rotations,
// skipped passes, cap error, and per round the next active count, the
// classes, the split flag and the next large count) is written to the
// caller's pinned words, which the caller reads once the stream has passed
// the call; so are the card's clock at the setup's start and at the last
// column's end, the call's time on the card. The rule: stop after a round that leaves no active rotation,
// or in which no active class split (the partition at 2h equals the one at
// h).
//
// The batched call (tpubz_bwt_forward_batch, the counterpart of tpubz's
// lax.map of bwt_forward(..., skip_converged="batch") in
// tpubz/dist/sharded.py) runs up to 32 rows, each with its own scratch at a
// fixed stride: its own state, lists, rank, sa, histograms, tickets and
// status words, so the radix passes' (round, pass) tags stay unique within
// a row. Every kernel takes the rows as grid dimension y. A row of one byte
// (a pad row) takes no round. The one-block call is the batch of one row.
//
// What bounds it on an H100, per round of m active keys: the large list's
// passes at 16 bytes a key each (radix.cuh), the key build's gathers of
// rank, the small list's 20 bytes a key (list entry, two ranks, the key
// written), the re-rank's scatter of rank (32-byte sectors for 4-byte
// words), all inside the 50 MB L2. The re-rank's writes of sa and of the
// next lists go out through shared memory, consecutive threads to
// consecutive slots, so that they fill whole sectors.
#include <cuda_runtime.h>

#include <chrono>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "block_scan.cuh"
#include "radix.cuh"

namespace {

using tpubz::radix::digit_of;
using tpubz::radix::digit_peers;
using tpubz::radix::kBins;
using tpubz::radix::kDigitBits;
using tpubz::radix::kFull;
using tpubz::radix::kMaxPasses;
using tpubz::radix::kTile;
using tpubz::radix::tag_of;
using tpubz::radix::tiles_of;

constexpr int kThreads = 256;
constexpr int kMaxRows = 32;  // rows a batched call takes
constexpr int kRankPer = 8;  // sorted keys a thread of the re-rank holds
constexpr int kRankTile = kThreads * kRankPer;
constexpr int kMaxLog2 = 20;
constexpr int kMaxRankTiles = (1 << kMaxLog2) / kRankTile;
constexpr int kMaxRounds = 24;  // state slots; the round cap at 2^20 is 20
constexpr int kSeedBytes = 5;
constexpr int kKeyLo = kMaxLog2, kKeyHi = 3 * kMaxLog2;  // the sorted bits
constexpr int kPasses = tpubz::radix::passes_of(kKeyLo, kKeyHi);
constexpr int64_t kPosMask = (1 << kMaxLog2) - 1;
constexpr int kAggs = 6;  // per re-rank tile: last class start, last head, heads, starts, active, first head
// per re-rank tile, from bwt_rank_scan: the last class start and the last
// head before it, the first head after it, the large and small members
// and the large classes before it
enum { kScanStart, kScanBefore, kScanAfter, kScanLarge, kScanSmall, kScanOrdinal, kScans };
// the small list: classes of at most kSmallTile keys, a chunk a CTA
constexpr int kSmallTile = kTile;
constexpr int kSmallThreads = 512;
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kSmallPer = 16;
constexpr int kSmallCap = kSmallThreads * kSmallPer;  // 2 * kSmallTile: a chunk's keys
constexpr int kSmallBins = 512;                        // the widest digit: 9 bits
// the chunk's local key: class start in the chunk << 40 | rank[(i + h) mod n]
// << 20 | i, sorted by bits 20-52 in four passes
constexpr int kSmallPasses = 4;
// a chunk whose classes have at most kCountMax keys each skips the passes:
// each key counts the keys of its class that go before it
constexpr int kCountMax = 64;
static_assert(kRankTile <= kSmallTile, "a class inside a re-rank tile is small");
// a large class has more than kSmallTile members: at most 255 of them, so
// a large-list key carries its class's ordinal in bits 40-47 in place of
// its rank, and the passes over bits 48-59 (and 44-51 with 16 classes or
// fewer) find one digit and are skipped
constexpr int kMaxLarge = (1 << kMaxLog2) / (kSmallTile + 1) + 1;
static_assert(kMaxLarge <= 256, "a large class's ordinal fits 8 bits");
constexpr int kOrdShift = kMaxLog2;  // a large-list entry: i | ordinal << 20
static_assert(kSmallCap >= 2 * kSmallTile && kSmallCap <= (1 << 13), "a chunk's class starts fit 13 bits");
// the graph body's kernels, in the order of their launch counts
enum { kKeysK, kPassK, kSmallK, kTilesK, kScanK, kApplyK, kEndK, kBodyKernels };
// the pinned words of a row: its record, then kPinnedPerRound a round
constexpr int kPinnedRecord = 6;  // rounds, active rotations sorted, skipped passes, cap error,
                                  // sorts (rounds whose large list was not empty), passes run
constexpr int kPinnedTimer = kPinnedRecord + kBodyKernels;  // then each body kernel's launches
                                                            // (row 0's words; 0 in other rows)
constexpr int kPinnedHead = kPinnedTimer + 2;  // then the low words of %globaltimer at the start of
                                               // bwt_setup and at the end of the row's
                                               // bwt_last_column CTA 0
constexpr int kPinnedPerRound = 4;  // next active count, classes, split, next large count
constexpr int kPinnedPerRow = kPinnedHead + kPinnedPerRound * kMaxRounds;
// launches of one round (the graph body) and of one call around it
constexpr int kOwnPerRound = kBodyKernels - 1;  // every body kernel but bwt_pass, once
constexpr int kOwnPerCall = 2;                  // the setup and bwt_last_column

size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

// A row's scratch: the two key buffers, rank, sa, the large and the small
// list of each round's parity, the small list's chunk starts, the
// re-rank's tile aggregates and their scans, each round parity's rank of the large
// classes by ordinal, then the words zeroed once per call: the state, a
// ticket per round and pass, each round's histogram, the radix status
// words.
struct Layout {
  long long keys[2], rank, sa, act_large[2], act_small[2], chunk, agg, scan, table[2], zero,
      state, tickets, hist, status, bytes;
  Layout() = default;
  Layout(int n, int cap) {
    const size_t n8 = align256(8 * static_cast<size_t>(n)), n4 = align256(4 * static_cast<size_t>(n));
    keys[0] = 0;
    keys[1] = n8;
    rank = 2 * n8;
    sa = rank + n4;
    act_large[0] = sa + n4;
    act_large[1] = act_large[0] + n4;
    act_small[0] = act_large[1] + n4;
    act_small[1] = act_small[0] + n4;
    chunk = act_small[1] + n4;
    agg = chunk + align256(4 * static_cast<size_t>(n / kSmallTile + 2));
    scan = agg + align256(4 * kAggs * kMaxRankTiles);
    table[0] = scan + align256(4 * kScans * kMaxRankTiles);
    table[1] = table[0] + align256(4 * kMaxLarge);
    zero = table[1] + align256(4 * kMaxLarge);
    state = zero;
    tickets = state + align256(4 * kStateWords);
    hist = tickets + 4 * static_cast<long long>(cap) * kMaxPasses;
    status = hist + (static_cast<long long>(cap) * kPasses << kDigitBits) * 4;
    bytes = status + (static_cast<long long>(tiles_of(n)) << kDigitBits) * 4;
  }
  // the state's int32 words, from `state` on
  static constexpr int kLarge = 0;                            // m_large[r]: round r's large list
  static constexpr int kSmall = kLarge + kMaxRounds + 1;      // m_small[r]
  static constexpr int kDone = kSmall + kMaxRounds + 1;       // done[r]: round r's stop rule held
  static constexpr int kSel = kDone + kMaxRounds;             // sel[r][p]: the buffer pass p reads
  static constexpr int kFinished = kSel + kMaxRounds * (kMaxPasses + 1);
  static constexpr int kRounds = kFinished + 1;  // rounds run
  static constexpr int kActive = kRounds + 1;    // active rotations sorted
  static constexpr int kSkipped = kActive + 1;   // radix passes skipped
  static constexpr int kError = kSkipped + 1;    // the cap reached short of the stop rule
  static constexpr int kSorts = kError + 1;      // rounds whose large list was not empty
  static constexpr int kPassesRun = kSorts + 1;  // radix passes that moved keys
  static constexpr int kRound = kPassesRun + 1;  // row 0's: the round the loop is at
  static constexpr int kLaunched = kRound + 1;   // row 0's: each body kernel's launches
  static constexpr int kStateWords = kLaunched + kBodyKernels;
};

// A call's parameters, copied by value into the graph's block by the setup
// launch; every kernel of the body reads them.
struct Call {
  const uint8_t* data;  // row b's block at data + b * N
  unsigned char* scratch;
  int* pinned;  // the card's address of the caller's pinned words
  long long stride;
  int B, N, min_n;
  int n[kMaxRows];
  int cap[kMaxRows];
  Layout L;
};

// (i + k) mod n for 0 <= i < n and 0 <= k < n: i + k < 2n <= 2^21
__device__ __forceinline__ int wrap(int i, int k, int n) {
  const int j = i + k;
  return j >= n ? j - n : j;
}

// What a CTA of the body knows of its row (blockIdx.y) and the round.
struct RowCtx {
  unsigned char* base;
  int32_t* state;
  int n, R;
  bool live;
  int m_large, m_small;  // the round's lists (round 0: all n rotations, one class)

  __device__ RowCtx(const Call& c) {
    const int b = blockIdx.y;
    base = c.scratch + b * c.stride;
    state = reinterpret_cast<int32_t*>(base + c.L.state);
    n = c.n[b];
    R = reinterpret_cast<const int32_t*>(c.scratch + c.L.state)[Layout::kRound];
    live = n >= c.min_n && n >= 1 && state[Layout::kFinished] == 0 && R < c.cap[b];
    m_large = !live ? 0 : R == 0 ? n : state[Layout::kLarge + R];
    m_small = !live || R == 0 ? 0 : state[Layout::kSmall + R];
  }
  template <typename T>
  __device__ T* at(long long off) const {
    return reinterpret_cast<T*>(base + off);
  }
  __device__ int32_t* sel() const { return state + Layout::kSel + R * (kMaxPasses + 1); }
  // the round's shift, reduced mod n
  __device__ int shift() const {
    return R > 0 ? static_cast<int>((static_cast<long long>(kSeedBytes) << (R - 1)) % n) : 0;
  }
};

// The body kernel k counts its launch: CTA (0, 0), before any gate, adds one
// to row 0's word, so the record holds what the card ran, whether or not a
// CTA of the launch had work.
__device__ __forceinline__ void count_launch(const Call& c, int k) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    ++reinterpret_cast<int32_t*>(c.scratch + c.L.state)[Layout::kLaunched + k];
  }
}

// The low 32 bits of the card's nanosecond clock: a call's span on the card
// is the difference of two readings, modulo 2^32.
__device__ __forceinline__ int32_t timer_lo() {
  uint32_t t;
  asm volatile("mov.u32 %0, %%globaltimer_lo;" : "=r"(t));
  return static_cast<int32_t>(t);
}

// The setup launch: the call's parameters into the graph's block, and the
// call's start on the card into each row's record.
__global__ void bwt_setup(Call call, Call* dst) {
  const int32_t t = timer_lo();
  if (threadIdx.x < call.B) call.pinned[threadIdx.x * kPinnedPerRow + kPinnedTimer] = t;
  if (threadIdx.x == 0) *dst = call;
}

// The large list's keys of the CTA's row (all n rotations in round 0), into
// key buffer 0, and every digit's count: a later round's key is the class's
// ordinal << 40 | rank[(i + h) mod n] << 20 | i.
__global__ void __launch_bounds__(kThreads) bwt_keys(const Call* __restrict__ cp) {
  __shared__ uint32_t s_hist[kPasses << kDigitBits];
  const Call& c = *cp;
  count_launch(c, kKeysK);
  const RowCtx rc(c);
  const int m = rc.m_large;
  const int base = blockIdx.x * kTile;
  if (base >= m) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) ++rc.state[Layout::kSorts];
  const int n = rc.n, R = rc.R;
  const uint8_t* block = c.data + static_cast<size_t>(blockIdx.y) * c.N;
  const int32_t* rank = rc.at<int32_t>(c.L.rank);
  const int32_t* act = rc.at<int32_t>(c.L.act_large[R & 1]);
  int64_t* keys = rc.at<int64_t>(c.L.keys[0]);
  uint32_t* hist = rc.at<uint32_t>(c.L.hist) + (static_cast<size_t>(R) * kPasses << kDigitBits);
  const int h = rc.shift();
  for (int x = threadIdx.x; x < kPasses << kDigitBits; x += kThreads) s_hist[x] = 0;
  __syncthreads();
  constexpr int kPer = tpubz::radix::kPer;
  int64_t key[kPer];
  if (R == 0) {
#pragma unroll 4
    for (int j = 0; j < kPer; ++j) {
      // the cyclic bytes from q on, whatever n is (n = 1: the byte again)
      const int q = base + j * kThreads + threadIdx.x;
      uint64_t packed = 0;
      int i = q < m ? q : 0;
#pragma unroll
      for (int b = 0; b < kSeedBytes; ++b) {
        packed = (packed << 8) | block[i];
        i = i + 1 == n ? 0 : i + 1;
      }
      key[j] = static_cast<int64_t>(packed << kMaxLog2) | q;
    }
  } else {
    // every load issued before any is used: the entries, then the ranks
    int e[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = base + j * kThreads + threadIdx.x;
      e[j] = q < m ? __ldg(act + q) : 0;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = e[j] & static_cast<int>(kPosMask);
      key[j] = (static_cast<int64_t>(e[j] >> kOrdShift) << (2 * kMaxLog2)) |
               (static_cast<int64_t>(__ldg(rank + wrap(i, h, n))) << kMaxLog2) | i;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int q = base + j * kThreads + threadIdx.x;
    if (q < m) keys[q] = key[j];
    tpubz::radix::hist_add(s_hist, key[j], q < m, kKeyLo, kKeyHi);
  }
  tpubz::radix::hist_flush(s_hist, hist, kPasses);
}

// Pass p of the round's sort of the large list: from the buffer sel[p]
// names into the other, or skipped when one digit holds every key (the
// order stays; sel[p + 1] = sel[p]).
__global__ void __launch_bounds__(kThreads) bwt_pass(const Call* __restrict__ cp, int p) {
  __shared__ int s_skip;
  const Call& c = *cp;
  count_launch(c, kPassK);
  const RowCtx rc(c);
  const int m = rc.m_large;
  if (blockIdx.x >= tiles_of(m)) return;
  const int R = rc.R;
  const uint32_t* hist = rc.at<uint32_t>(c.L.hist) + ((static_cast<size_t>(R) * kPasses + p) << kDigitBits);
  int32_t* sel = rc.sel();
  const int from = sel[p];
  if (threadIdx.x == 0) s_skip = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    if (hist[b] == static_cast<uint32_t>(m)) s_skip = 1;
  }
  __syncthreads();
  const bool skip = s_skip != 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sel[p + 1] = skip ? from : 1 - from;
    ++rc.state[skip ? Layout::kSkipped : Layout::kPassesRun];
  }
  if (skip) return;
  const int shift = kKeyLo + p * kDigitBits;
  tpubz::radix::onesweep_pass(rc.at<int64_t>(c.L.keys[from]), rc.at<int64_t>(c.L.keys[1 - from]), shift,
                              kKeyHi - shift < kDigitBits ? kKeyHi - shift : kDigitBits, hist,
                              rc.at<uint32_t>(c.L.status),
                              rc.at<uint32_t>(c.L.tickets) + R * kMaxPasses + p, tag_of(R, p), m);
}

struct SmallSmem {
  int64_t keys[kSmallCap];                   // the chunk's local keys, in the current order
  int32_t g[kSmallCap];                      // the list entries, then each input position's class rank
  uint16_t warp[kSmallWarps][kSmallBins];    // per warp and digit: its keys, then the warps' before
  int start[kSmallBins];                     // the digit's first index in the chunk's order
  int sh[32];
};
constexpr size_t kSmallSmemBytes = sizeof(SmallSmem);

// One chunk of the round's small list: the classes that start within list
// entries [k * kSmallTile, (k + 1) * kSmallTile), from the chunk start the
// round before wrote to the next chunk's. Each class keeps its range; in it
// the keys go in order of rank[(i + h) mod n], equal ones in list order
// (stable), as the radix sort orders them.
__global__ void __launch_bounds__(kSmallThreads, 1) bwt_small_sort(const Call* __restrict__ cp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmallSmem& s = *reinterpret_cast<SmallSmem*>(smem_raw);
  const Call& c = *cp;
  count_launch(c, kSmallK);
  const RowCtx rc(c);
  const int ms = rc.m_small;
  const int chunks = (ms + kSmallTile - 1) / kSmallTile;
  const int k = blockIdx.x;
  if (k >= chunks) return;
  const int n = rc.n, R = rc.R, h = rc.shift();
  const int32_t* chunk = rc.at<int32_t>(c.L.chunk);
  const int begin = chunk[k];
  const int cnt = (k + 1 < chunks ? chunk[k + 1] : ms) - begin;
  const int32_t* act = rc.at<int32_t>(c.L.act_small[R & 1]) + begin;
  const int32_t* rank = rc.at<int32_t>(c.L.rank);
  int64_t* out = rc.at<int64_t>(c.L.keys[rc.sel()[kPasses]]) + rc.m_large + begin;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const unsigned below = (1u << lane) - 1;

  // the list entries, coalesced; then thread t holds the `per` entries
  // from t * per on, every load of them issued before any is used
  const int per = (cnt + kSmallThreads - 1) / kSmallThreads;
  for (int x = t; x < cnt; x += kSmallThreads) s.g[x] = act[x];
  __syncthreads();
  int64_t key[kSmallPer];
  int gv[kSmallPer];
#pragma unroll
  for (int j = 0; j < kSmallPer; ++j) {
    const int x = t * per + j;
    gv[j] = j < per && x < cnt ? s.g[x] : 0;  // the entry i, for now
  }
#pragma unroll
  for (int j = 0; j < kSmallPer; ++j) key[j] = __ldg(rank + wrap(gv[j], h, n));
#pragma unroll
  for (int j = 0; j < kSmallPer; ++j) {
    const int i = gv[j];
    key[j] = (key[j] << kMaxLog2) | i;
    gv[j] = __ldg(rank + i);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSmallPer; ++j) {
    if (j < per && t * per + j < cnt) s.g[t * per + j] = gv[j];
  }
  __syncthreads();
  // each key's class start in the chunk (the chunk starts a class)
  int prev = t * per > 0 && t * per <= cnt ? s.g[t * per - 1] : -1;
  int my_start = -1;
  bool starts[kSmallPer];
#pragma unroll
  for (int j = 0; j < kSmallPer; ++j) {
    const int x = t * per + j;
    starts[j] = j < per && x < cnt && (x == 0 || gv[j] != prev);
    if (starts[j]) my_start = x;
    prev = gv[j];
  }
  int unused;
  int cs = tpubz::block_exclusive(my_start, -1, tpubz::Max(), s.sh, &unused);
  int deepest = 0;  // the most keys of one class up to one of this thread's
#pragma unroll
  for (int j = 0; j < kSmallPer; ++j) {
    const int x = t * per + j;
    if (starts[j]) cs = x;
    if (j < per && x < cnt) {
      s.keys[x] = (static_cast<int64_t>(cs) << (2 * kMaxLog2)) | key[j];
      deepest = max(deepest, x - cs + 1);
    }
  }
  int biggest;
  tpubz::block_exclusive(deepest, 0, tpubz::Max(), s.sh, &biggest);  // its barriers order s.keys
  constexpr int64_t kLow = (static_cast<int64_t>(1) << (2 * kMaxLog2)) - 1;
  if (biggest <= kCountMax) {
    // classes of at most kCountMax keys: a key's place in its class is the
    // count of the class's keys before it by (rank[(i + h) mod n], entry)
#pragma unroll
    for (int j = 0; j < kSmallPer; ++j) {
      const int x = t * per + j;
      if (j < per && x < cnt) {
        const int64_t kx = s.keys[x];
        const int first = static_cast<int>(kx >> (2 * kMaxLog2));
        const int64_t rx = kx & kLow;
        int before = 0;
        for (int y = first; y < cnt; ++y) {
          const int64_t ky = s.keys[y];
          if (static_cast<int>(ky >> (2 * kMaxLog2)) != first) break;
          const int64_t ry = ky & kLow;
          before += (ry >> kMaxLog2) < (rx >> kMaxLog2) || ((ry >> kMaxLog2) == (rx >> kMaxLog2) && y < x);
        }
        out[first + before] = (static_cast<int64_t>(gv[j]) << (2 * kMaxLog2)) | rx;
      }
    }
    return;
  }

  // four stable LSD passes over bits 20-52 in shared memory; the chunk's
  // entries spread over every warp, `per` a lane: warp w ranks entries
  // [w * 32 * per, (w + 1) * 32 * per), lanes side by side
#pragma unroll 1
  for (int p = 0; p < kSmallPasses; ++p) {
    const int shift = kKeyLo + 8 * p;
    const int width = p + 1 < kSmallPasses ? 8 : 9;
    const int bins = 1 << width;
    int pos[kSmallPer];
#pragma unroll
    for (int j = 0; j < kSmallPer; ++j) {
      const int x = (w * per + j) * 32 + lane;
      key[j] = j < per && x < cnt ? s.keys[x] : 0;
    }
    for (int x = t; x < kSmallWarps * kSmallBins; x += kSmallThreads) (&s.warp[0][0])[x] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSmallPer; ++j) {
      if (j >= per) break;  // the same for the whole CTA
      const bool valid = (w * per + j) * 32 + lane < cnt;
      const uint32_t d = digit_of(key[j], shift, width);
      const unsigned peers = digit_peers(d, valid);
      const int prior = valid ? s.warp[w][d] : 0;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) s.warp[w][d] = static_cast<uint16_t>(prior + __popc(peers));
      __syncwarp();
      pos[j] = prior + __popc(peers & below);
    }
    __syncthreads();
    // thread t owns digit t: the earlier warps' counts in place, the total
    int total = 0;
    if (t < bins) {
      for (int v = 0; v < kSmallWarps; ++v) {
        const int cv = s.warp[v][t];
        s.warp[v][t] = static_cast<uint16_t>(total);
        total += cv;
      }
    }
    // one digit holds every key: the order stays
    if (__syncthreads_or(t < bins && total == cnt)) continue;
    const int first = tpubz::block_exclusive(total, 0, tpubz::Sum(), s.sh, &unused);
    if (t < bins) s.start[t] = first;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSmallPer; ++j) {
      if (j < per && (w * per + j) * 32 + lane < cnt) {
        const uint32_t d = digit_of(key[j], shift, width);
        pos[j] += s.start[d] + s.warp[w][d];
      }
    }
#pragma unroll
    for (int j = 0; j < kSmallPer; ++j) {
      if (j < per && (w * per + j) * 32 + lane < cnt) s.keys[pos[j]] = key[j];
    }
    __syncthreads();
  }
  // each class kept its range: the key at x takes back the class rank of
  // the entry that was at x
  for (int x = t; x < cnt; x += kSmallThreads) {
    out[x] = (static_cast<int64_t>(s.g[x]) << (2 * kMaxLog2)) | (s.keys[x] & kLow);
  }
}

// The flags of this thread's kRankPer sorted keys from `base` on (m keys in
// all, the large list's first ml): head (bits 20-59 differ from the key
// before; key 0 and key ml are heads), class start (bits 40-59, the old
// class's ordinal or rank in rounds >= 1, differ; key ml starts a class;
// in round 0 all rotations are one class) and whether the key's new class
// has company.
struct Flags {
  int64_t key[kRankPer];
  bool head[kRankPer], start[kRankPer], active[kRankPer];
};

__device__ __forceinline__ void load_flags(const int64_t* __restrict__ skey, int base, int m, int ml,
                                           int round, Flags& f) {
  const int gshift = round > 0 ? 2 * kMaxLog2 : 63;  // round 0: g = 0 for every key
  int64_t prev = base > 0 && base <= m ? skey[base - 1] : 0;
  bool head_next = true;  // past the last key
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    const int idx = base + q;
    f.key[q] = idx < m ? skey[idx] : 0;
  }
  // the small list's first key starts a class and a head whatever its bits
  // (the large list's keys carry ordinals, the small list's ranks)
  if (base + kRankPer < m) {
    head_next = base + kRankPer == ml ||
                (skey[base + kRankPer] >> kKeyLo) != (f.key[kRankPer - 1] >> kKeyLo);
  }
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    const int idx = base + q;
    const int64_t k = f.key[q];
    f.head[q] = idx < m && (idx == 0 || idx == ml || (k >> kKeyLo) != (prev >> kKeyLo));
    f.start[q] = idx < m && (idx == 0 || idx == ml || (k >> gshift) != (prev >> gshift));
    prev = k;
  }
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    const bool next = q + 1 < kRankPer ? (base + q + 1 >= m || f.head[q + 1]) : head_next;
    f.active[q] = base + q < m && !(f.head[q] && next);
  }
}

constexpr int kNone = 0x7fffffff;  // no head: the first head's identity under min

// agg[k * kMaxRankTiles + tile], k: last class start, last head (-1 if
// none), heads, class starts, active keys, first head (kNone if none)
__global__ void __launch_bounds__(kThreads) bwt_rank_tiles(const Call* __restrict__ cp) {
  __shared__ int sh[32];
  const Call& c = *cp;
  count_launch(c, kTilesK);
  const RowCtx rc(c);
  const int m = rc.m_large + rc.m_small;
  if (blockIdx.x * kRankTile >= m) return;
  const int64_t* skey = rc.at<int64_t>(c.L.keys[rc.sel()[kPasses]]);
  int32_t* agg = rc.at<int32_t>(c.L.agg);
  const int base = blockIdx.x * kRankTile + threadIdx.x * kRankPer;
  Flags f;
  load_flags(skey, base, m, rc.m_large, rc.R, f);
  int last_start = -1, last_head = -1, heads = 0, starts = 0, active = 0, first_head = kNone;
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    if (f.start[q]) last_start = base + q;
    if (f.head[q]) last_head = base + q;
    if (f.head[q] && first_head == kNone) first_head = base + q;
    heads += f.head[q];
    starts += f.start[q];
    active += f.active[q];
  }
  int out[kAggs];
  tpubz::block_exclusive(last_start, -1, tpubz::Max(), sh, &out[0]);
  tpubz::block_exclusive(last_head, -1, tpubz::Max(), sh, &out[1]);
  tpubz::block_exclusive(heads, 0, tpubz::Sum(), sh, &out[2]);
  tpubz::block_exclusive(starts, 0, tpubz::Sum(), sh, &out[3]);
  tpubz::block_exclusive(active, 0, tpubz::Sum(), sh, &out[4]);
  tpubz::block_exclusive(first_head, kNone, tpubz::Min(), sh, &out[5]);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < kAggs; ++q) agg[q * kMaxRankTiles + blockIdx.x] = out[q];
  }
}

// A tile index's word in the re-rank's shared arrays: one pad word every
// 32, so that neither the threads' runs of kRankPer nor a warp's 32
// consecutive indices share a bank.
__device__ __forceinline__ int padded(int x) { return x + (x >> 5); }
constexpr int kPaddedRankTile = kRankTile + kRankTile / 32;
constexpr int kTilesPer = kMaxRankTiles / kThreads;  // tiles a thread of the re-rank scans

// Exclusive scan under op of v over the tiles (tile t's value v[t], t <
// tiles), as each thread's kTilesPer consecutive tiles and a CTA scan; out[t]
// gets the scan, *total the whole. reverse: from the last tile down.
template <typename Op>
__device__ void scan_tiles(const int* v, int* out, int tiles, int identity, Op op, bool reverse,
                           int* sh, int* total) {
  int x[kTilesPer];
  int run = identity;
#pragma unroll
  for (int k = 0; k < kTilesPer; ++k) {
    const int u = threadIdx.x * kTilesPer + k;
    const int tt = reverse ? tiles - 1 - u : u;
    x[k] = u < tiles ? v[tt] : identity;
    run = op(run, x[k]);
  }
  run = tpubz::block_exclusive(run, identity, op, sh, total);
#pragma unroll
  for (int k = 0; k < kTilesPer; ++k) {
    const int u = threadIdx.x * kTilesPer + k;
    if (u < tiles) out[reverse ? tiles - 1 - u : u] = run;
    run = op(run, x[k]);
  }
}

// One CTA a row: from the tiles' aggregates, per tile the last class start
// and the heads before it, the first head after it, the members of large
// and small new classes and the large classes that start before it (only
// the classes that cross a tile's edges can be large); and the round's
// state and record.
__global__ void __launch_bounds__(kThreads) bwt_rank_scan(const Call* __restrict__ cp) {
  __shared__ int sh[32];
  __shared__ int s_first[kMaxRankTiles], s_last[kMaxRankTiles], s_act[kMaxRankTiles];
  __shared__ int s_prev[kMaxRankTiles], s_next[kMaxRankTiles], s_large[kMaxRankTiles];
  __shared__ int s_small[kMaxRankTiles], s_lh[kMaxRankTiles], s_starts[kMaxRankTiles];
  const Call& c = *cp;
  count_launch(c, kScanK);
  const RowCtx rc(c);
  const int m = rc.m_large + rc.m_small;
  if (m == 0) return;
  const int n = rc.n, R = rc.R;
  const int32_t* agg = rc.at<int32_t>(c.L.agg);
  int32_t* scan = rc.at<int32_t>(c.L.scan);
  const int tiles = (m + kRankTile - 1) / kRankTile;
  int heads = 0, starts = 0;
  for (int tt = threadIdx.x; tt < tiles; tt += kThreads) {
    s_first[tt] = agg[5 * kMaxRankTiles + tt];
    s_last[tt] = agg[kMaxRankTiles + tt];
    s_act[tt] = agg[4 * kMaxRankTiles + tt];
    s_starts[tt] = agg[tt];
    heads += agg[2 * kMaxRankTiles + tt];
    starts += agg[3 * kMaxRankTiles + tt];
  }
  tpubz::block_exclusive(heads, 0, tpubz::Sum(), sh, &heads);  // its barriers order s_*
  tpubz::block_exclusive(starts, 0, tpubz::Sum(), sh, &starts);
  int unused;
  scan_tiles(s_last, s_prev, tiles, -1, tpubz::Max(), false, sh, &unused);
  scan_tiles(s_first, s_next, tiles, kNone, tpubz::Min(), true, sh, &unused);
  __syncthreads();
  for (int tt = threadIdx.x; tt < tiles; tt += kThreads) {
    const int b = tt * kRankTile, e = min(b + kRankTile, m);
    const int after = min(s_next[tt], m);
    int large = 0, lh = 0;
    if (s_first[tt] == kNone) {
      if (after - s_prev[tt] > kSmallTile) large = e - b;
    } else {
      if (s_first[tt] > b && s_first[tt] - s_prev[tt] > kSmallTile) large += s_first[tt] - b;
      if (after - s_last[tt] > kSmallTile) {
        large += e - s_last[tt];
        lh = 1;
      }
    }
    s_large[tt] = large;
    s_small[tt] = s_act[tt] - large;
    s_lh[tt] = lh;
    scan[kScanBefore * kMaxRankTiles + tt] = s_prev[tt];
    scan[kScanAfter * kMaxRankTiles + tt] = after;
  }
  __syncthreads();
  int large_all, small_all;
  scan_tiles(s_large, s_large, tiles, 0, tpubz::Sum(), false, sh, &large_all);
  scan_tiles(s_small, s_small, tiles, 0, tpubz::Sum(), false, sh, &small_all);
  scan_tiles(s_lh, s_lh, tiles, 0, tpubz::Sum(), false, sh, &unused);
  scan_tiles(s_starts, s_starts, tiles, -1, tpubz::Max(), false, sh, &unused);
  for (int tt = threadIdx.x; tt < tiles; tt += kThreads) {
    scan[kScanStart * kMaxRankTiles + tt] = s_starts[tt];
    scan[kScanLarge * kMaxRankTiles + tt] = s_large[tt];
    scan[kScanSmall * kMaxRankTiles + tt] = s_small[tt];
    scan[kScanOrdinal * kMaxRankTiles + tt] = s_lh[tt];
  }
  if (threadIdx.x == 0) {
    const int active = large_all + small_all;
    const bool split = heads > starts;
    rc.state[Layout::kLarge + R + 1] = large_all;
    rc.state[Layout::kSmall + R + 1] = small_all;
    rc.state[Layout::kDone + R] = active == 0 || !split;
    int* pinned = c.pinned + static_cast<size_t>(blockIdx.y) * kPinnedPerRow + kPinnedHead + kPinnedPerRound * R;
    pinned[0] = active;
    pinned[1] = n - m + heads;  // classes of all n rotations
    pinned[2] = split;
    pinned[3] = large_all;
  }
}

// The re-rank of the round's m sorted keys.
__global__ void __launch_bounds__(kThreads) bwt_rank_apply(const Call* __restrict__ cp) {
  __shared__ int sh[32];
  // per key of the tile: its position, its slot and where it goes next
  // (>= 0: the large list's index | its class's ordinal << 20; <= -2: the
  // small list's -(index + 2); -1: it leaves both)
  __shared__ int s_pos[kPaddedRankTile], s_slot[kPaddedRankTile], s_out[kPaddedRankTile];
  __shared__ int s_after[kThreads];  // the first head past each thread's run
  const Call& c = *cp;
  count_launch(c, kApplyK);
  const RowCtx rc(c);
  const int m = rc.m_large + rc.m_small;
  if (blockIdx.x * kRankTile >= m) return;
  const int R = rc.R, bid = blockIdx.x;
  const int64_t* skey = rc.at<int64_t>(c.L.keys[rc.sel()[kPasses]]);
  const int32_t* scan = rc.at<int32_t>(c.L.scan);
  int32_t* rank = rc.at<int32_t>(c.L.rank);
  int32_t* sa = rc.at<int32_t>(c.L.sa);
  int32_t* next_large = rc.at<int32_t>(c.L.act_large[(R + 1) & 1]);
  int32_t* next_small = rc.at<int32_t>(c.L.act_small[(R + 1) & 1]);
  int32_t* chunk = rc.at<int32_t>(c.L.chunk);
  const int32_t* table = rc.at<int32_t>(c.L.table[R & 1]);
  int32_t* next_table = rc.at<int32_t>(c.L.table[(R + 1) & 1]);
  const int ml = rc.m_large;
  // the tile's share of bwt_rank_scan's
  const int start_before = scan[kScanStart * kMaxRankTiles + bid];
  const int head_before = scan[kScanBefore * kMaxRankTiles + bid];
  const int head_after = scan[kScanAfter * kMaxRankTiles + bid];
  const int large_before = scan[kScanLarge * kMaxRankTiles + bid];
  const int small_before = scan[kScanSmall * kMaxRankTiles + bid];
  const int32_t* ordinal_of_tile = scan + kScanOrdinal * kMaxRankTiles;
  int unused;

  const int base = bid * kRankTile + threadIdx.x * kRankPer;
  Flags f;
  load_flags(skey, base, m, rc.m_large, R, f);
  int my_start = -1, my_head = -1, my_first_head = kNone;
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    if (f.start[q]) my_start = base + q;
    if (f.head[q]) my_head = base + q;
    if (f.head[q] && my_first_head == kNone) my_first_head = base + q;
  }
  int first = max(start_before, tpubz::block_exclusive(my_start, -1, tpubz::Max(), sh, &unused));
  int headq = max(head_before, tpubz::block_exclusive(my_head, -1, tpubz::Max(), sh, &unused));
  // the first head past each thread's run: a scan of the runs' first heads
  // from the last thread down
  s_after[threadIdx.x] = my_first_head;
  __syncthreads();
  const int mirror = kThreads - 1 - threadIdx.x;
  const int later = tpubz::block_exclusive(s_after[mirror], kNone, tpubz::Min(), sh, &unused);
  __syncthreads();
  s_after[mirror] = min(later, head_after);
  __syncthreads();
  int after[kRankPer];
  int nxt = s_after[threadIdx.x];
#pragma unroll
  for (int q = kRankPer - 1; q >= 0; --q) {
    after[q] = nxt;
    if (f.head[q]) nxt = base + q;
  }
  // each key's new class: its size, whether it is large; where it goes
  int size[kRankPer];
  int my_large = 0, my_small = 0;
  {
    int hq = headq;
#pragma unroll
    for (int q = 0; q < kRankPer; ++q) {
      if (f.head[q]) hq = base + q;
      size[q] = after[q] - hq;
      if (f.active[q]) (size[q] > kSmallTile ? my_large : my_small) += 1;
    }
  }
  int out_large = large_before + tpubz::block_exclusive(my_large, 0, tpubz::Sum(), sh, &unused);
  int out_small = small_before + tpubz::block_exclusive(my_small, 0, tpubz::Sum(), sh, &unused);
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    const int idx = base + q;
    if (idx < m) {
      if (f.start[q]) first = idx;
      if (f.head[q]) headq = idx;
      const int64_t k = f.key[q];
      const int i = static_cast<int>(k & kPosMask);
      // the old class's rank: a large-list key carries its ordinal
      const int g = R == 0 ? 0 : idx < ml ? table[k >> (2 * kMaxLog2)] : static_cast<int>(k >> (2 * kMaxLog2));
      rank[i] = g + headq - first;
      const int x = padded(threadIdx.x * kRankPer + q);
      s_pos[x] = i;
      s_slot[x] = g + idx - first;
      int o = -1;
      if (f.active[q]) {
        if (size[q] > kSmallTile) {
          const int ord = ordinal_of_tile[headq / kRankTile];
          if (idx == headq) next_table[ord] = g + headq - first;
          o = out_large++ | (ord << kOrdShift);
        } else {
          const int os = out_small++;
          o = -(os + 2);
          // a window of the small list starts its chunk at its first class
          // start: this class's own, or the next class's
          if (os % kSmallTile == 0) {
            chunk[os / kSmallTile] = idx == headq ? os : os - (idx - headq) + size[q];
          }
        }
      }
      s_out[x] = o;
    }
  }
  __syncthreads();
  const int count = min(kRankTile, m - bid * kRankTile);
  for (int x = threadIdx.x; x < count; x += kThreads) {
    const int i = s_pos[padded(x)];
    sa[s_slot[padded(x)]] = i;
    const int o = s_out[padded(x)];
    if (o >= 0) {
      next_large[o & static_cast<int>(kPosMask)] = i | (o & ~static_cast<int>(kPosMask));
    } else if (o <= -2) {
      next_small[-(o + 2)] = i;
    }
  }
}

// The round's end, a lane a row: the row's record (with the body's launch
// counts, its own among them); the round counter; the loop's condition
// (some row refines on, and none reached its cap).
__global__ void bwt_round_end(const Call* __restrict__ cp, cudaGraphConditionalHandle loop) {
  const Call& c = *cp;
  count_launch(c, kEndK);
  const int b = threadIdx.x;
  int32_t* row0 = reinterpret_cast<int32_t*>(c.scratch + c.L.state);
  const int R = row0[Layout::kRound];
  bool more = false, error = false;
  if (b < c.B) {
    int32_t* st = reinterpret_cast<int32_t*>(c.scratch + b * c.stride + c.L.state);
    const int n = c.n[b];
    if (n >= c.min_n && n >= 1 && st[Layout::kFinished] == 0) {
      st[Layout::kRounds] = R + 1;
      st[Layout::kActive] += R == 0 ? n : st[Layout::kLarge + R] + st[Layout::kSmall + R];
      if (st[Layout::kDone + R] != 0) {
        st[Layout::kFinished] = 1;
      } else if (R + 1 >= c.cap[b]) {
        st[Layout::kFinished] = 1;
        st[Layout::kError] = 1;
      } else {
        more = true;
      }
    }
    int* pinned = c.pinned + static_cast<size_t>(b) * kPinnedPerRow;
    pinned[0] = st[Layout::kRounds];
    pinned[1] = st[Layout::kActive];
    pinned[2] = st[Layout::kSkipped];
    pinned[3] = st[Layout::kError];
    pinned[4] = st[Layout::kSorts];
    pinned[5] = st[Layout::kPassesRun];
    for (int k = 0; k < kBodyKernels; ++k) pinned[kPinnedRecord + k] = st[Layout::kLaunched + k];
    error = st[Layout::kError] != 0;
  }
  more = __any_sync(kFull, more);
  error = __any_sync(kFull, error);
  if (b == 0) {
    row0[Layout::kRound] = R + 1;
    cudaGraphSetConditional(loop, more && !error ? 1u : 0u);
  }
}

// The rows' lengths, by value.
struct Lengths {
  int n[kMaxRows];
};

// Position p of row `row`'s column and, at p = 0, its key.
__device__ __forceinline__ void last_column_at(int p, size_t row, const uint8_t* __restrict__ data,
                                               int N, int n, const unsigned char* scratch,
                                               long long stride, long long sa_off,
                                               long long rank_off, uint8_t* __restrict__ last,
                                               int64_t* __restrict__ key) {
  const uint8_t* block = data + row * N;
  last += row * N;
  if (p >= n) {
    last[p] = 0;
    if (p == 0) key[row] = 0;
    return;
  }
  if (n == 1) {
    last[0] = block[0];
    key[row] = 0;
    return;
  }
  const unsigned char* base = scratch + row * stride;
  const int i = reinterpret_cast<const int32_t*>(base + sa_off)[p];
  last[p] = block[i == 0 ? n - 1 : i - 1];
  if (p == 0) key[row] = reinterpret_cast<const int32_t*>(base + rank_off)[0];
}

// Row b's column at last + b * N and its key at key[b]. A row of one byte is
// its own column, key 0, whether or not it ran a round; a row of none is
// all zero. Position 0's thread of each row writes the call's end on the
// card into the row's record (pinned: the card's address of the record).
__global__ void __launch_bounds__(kThreads)
    bwt_last_column(const uint8_t* __restrict__ data, int N, Lengths ns,
                    const unsigned char* scratch, long long stride, long long sa_off,
                    long long rank_off, uint8_t* __restrict__ last, int64_t* __restrict__ key,
                    int* __restrict__ pinned) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= N) return;
  const size_t row = blockIdx.y;
  last_column_at(p, row, data, N, ns.n[row], scratch, stride, sa_off, rank_off, last, key);
  if (p == 0) pinned[row * kPinnedPerRow + kPinnedTimer + 1] = timer_lo();
}

int blocks_for(int lanes, int per) { return (lanes + per - 1) / per; }

// The most doubling rounds a block of n bytes can need, plus one: round r
// compares kSeedBytes * 2^r bytes, and once that covers n the next round
// leaves no rotation active or splits no class.
int round_cap(int n) {
  int c = 0;
  while ((static_cast<long long>(kSeedBytes) << c) < n) ++c;
  return c + 2;
}

// One graph a (device, stream, rows, N, least n): its parameter block, the
// instantiated graph, and a lock that keeps a call's setup launch and graph
// launch together.
struct Graph {
  Call* params = nullptr;
  cudaGraphExec_t exec = nullptr;
  std::mutex lock;
};

// The body: one doubling round over B rows of at most N bytes, every
// kernel reading `params`.
cudaError_t capture_round(cudaStream_t cap, const Call* params, int B, int N,
                          cudaGraphConditionalHandle loop) {
  const int tiles = tiles_of(N > 0 ? N : 1);
  bwt_keys<<<dim3(tiles, B), kThreads, 0, cap>>>(params);
  for (int p = 0; p < kPasses; ++p) bwt_pass<<<dim3(tiles, B), kThreads, 0, cap>>>(params, p);
  bwt_small_sort<<<dim3(blocks_for(N, kSmallTile), B), kSmallThreads, kSmallSmemBytes, cap>>>(params);
  const dim3 rgrid(blocks_for(N, kRankTile), B);
  bwt_rank_tiles<<<rgrid, kThreads, 0, cap>>>(params);
  bwt_rank_scan<<<dim3(1, B), kThreads, 0, cap>>>(params);
  bwt_rank_apply<<<rgrid, kThreads, 0, cap>>>(params);
  bwt_round_end<<<1, 32, 0, cap>>>(params, loop);
  return cudaGetLastError();
}

cudaError_t build_graph(Graph& g, int B, int N) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      bwt_small_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmallSmemBytes));
  if (attr != cudaSuccess) return attr;
  if (cudaError_t e = cudaMalloc(reinterpret_cast<void**>(&g.params), sizeof(Call))) return e;
  cudaGraph_t graph = nullptr;
  cudaStream_t cap = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  cudaGraphConditionalHandle loop = 0;
  if (err == cudaSuccess) err = cudaGraphConditionalHandleCreate(&loop, graph, 1, cudaGraphCondAssignDefault);
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = loop;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t node;
  if (err == cudaSuccess) err = cudaGraphAddNode(&node, graph, nullptr, 0, &cp);
  if (err == cudaSuccess) err = cudaStreamCreateWithFlags(&cap, cudaStreamNonBlocking);
  if (err == cudaSuccess) {
    cudaGraph_t body = cp.conditional.phGraph_out[0];
    err = cudaStreamBeginCaptureToGraph(cap, body, nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
    if (err == cudaSuccess) {
      const cudaError_t launched = capture_round(cap, g.params, B, N, loop);
      err = cudaStreamEndCapture(cap, &body);
      if (launched != cudaSuccess) err = launched;
    }
  }
  if (err == cudaSuccess) err = cudaGraphInstantiate(&g.exec, graph, 0);
  if (cap != nullptr) cudaStreamDestroy(cap);
  if (graph != nullptr) cudaGraphDestroy(graph);
  return err;
}

// The graph for a call, built at its first call (*built_us gets the host µs).
cudaError_t graph_for(cudaStream_t st, int B, int N, int min_n, Graph** out, int* built_us) {
  static std::mutex cache_lock;
  static std::map<std::tuple<int, cudaStream_t, int, int, int>, Graph*> cache;
  int device = 0;
  if (cudaError_t e = cudaGetDevice(&device)) return e;
  const auto key = std::make_tuple(device, st, B, N, min_n);
  std::lock_guard<std::mutex> hold(cache_lock);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  const auto t = std::chrono::steady_clock::now();
  Graph* g = new Graph;
  if (cudaError_t e = build_graph(*g, B, N)) {
    return e;  // the half-built graph is left: a failed build is a fault of the card or the code
  }
  *built_us = static_cast<int>(std::chrono::duration_cast<std::chrono::microseconds>(
                                   std::chrono::steady_clock::now() - t)
                                   .count());
  cache.emplace(key, g);
  *out = g;
  return cudaSuccess;
}

// The call behind tpubz_bwt_forward and tpubz_bwt_forward_batch, which
// describe the arguments: B rows of N bytes at data, row b's first ns[b]
// valid. Rows shorter than min_n
// take no round (the batch's pad rows). stats (out, 5 ints): this file's
// launches outside the loop (the setup and the last column, each counted
// once it is enqueued), whether the graph ran, and the host's µs
// enqueueing, building the graph and in all. The body's launches are
// counted on the card, in the record.
int enqueue_bwt(const uint8_t* data, const int* ns, int B, int N, int min_n,
                int cap_override, void* scratch, long long scratch_bytes_given, int* pinned,
                int64_t* out_key, uint8_t* out_last, int* stats, cudaStream_t st) {
  using Clock = std::chrono::steady_clock;
  const auto us_since = [](Clock::time_point t) {
    return static_cast<int>(
        std::chrono::duration_cast<std::chrono::microseconds>(Clock::now() - t).count());
  };
  const auto t_call = Clock::now();
  for (int q = 0; q < 5; ++q) stats[q] = 0;
  if (B < 1 || B > kMaxRows || N < 1 || cap_override < 0 || cap_override > kMaxRounds) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int n_max = 1;
  for (int b = 0; b < B; ++b) {
    if (ns[b] < 0 || ns[b] > N || ns[b] > (1 << kMaxLog2)) return static_cast<int>(cudaErrorInvalidValue);
    n_max = ns[b] > n_max ? ns[b] : n_max;
  }
  Call call{};
  call.L = Layout(n_max, round_cap(n_max));
  const size_t stride = align256(call.L.bytes);
  if (scratch_bytes_given < 0 ||
      static_cast<size_t>(scratch_bytes_given) < (B - 1) * stride + call.L.bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  call.data = data;
  call.scratch = static_cast<unsigned char*>(scratch);
  call.stride = static_cast<long long>(stride);
  call.B = B;
  call.N = N;
  call.min_n = min_n;
  if (cudaError_t e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&call.pinned), pinned, 0)) {
    return static_cast<int>(e);
  }
  int nlive = 0;
  Lengths lengths{};
  for (int b = 0; b < B; ++b) {
    call.n[b] = lengths.n[b] = ns[b];
    const int own = round_cap(ns[b] > 0 ? ns[b] : 1);
    call.cap[b] = cap_override > 0 && cap_override < own ? cap_override : own;
    if (ns[b] >= min_n && ns[b] >= 1) ++nlive;
  }
  static_assert(kOwnPerCall == 2, "the setup and the last column");
  const auto t_enqueue = Clock::now();
  if (nlive > 0) {
    // every row's words zeroed (row 0's round counter among them)
    for (int b = 0; b < B; ++b) {
      if (cudaError_t e = cudaMemsetAsync(call.scratch + b * stride + call.L.zero, 0,
                                          call.L.bytes - call.L.zero, st)) {
        return static_cast<int>(e);
      }
    }
    Graph* g = nullptr;
    if (cudaError_t e = graph_for(st, B, N, min_n, &g, &stats[3])) return static_cast<int>(e);
    std::lock_guard<std::mutex> hold(g->lock);
    bwt_setup<<<1, 32, 0, st>>>(call, g->params);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    ++stats[0];
    if (cudaError_t e = cudaGraphLaunch(g->exec, st)) return static_cast<int>(e);
    stats[1] = 1;
  }
  bwt_last_column<<<dim3(blocks_for(N, kThreads), B), kThreads, 0, st>>>(
      data, N, lengths, call.scratch, call.stride, call.L.sa, call.L.rank, out_last, out_key,
      call.pinned);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  ++stats[0];
  stats[2] = us_since(t_enqueue) - stats[3];
  stats[4] = us_since(t_call);
  return 0;
}

}  // namespace

// What a call for a block of n bytes needs, so that no caller repeats the
// layout: sizes[0] the scratch's bytes, sizes[1] the pinned int32 words,
// sizes[2] the round cap, sizes[3] the radix passes a round runs,
// sizes[4] the pinned words of a row's record before its rounds' words
// (rounds, active rotations sorted, skipped passes, cap error, sorts,
// passes run, then each body kernel's launches, the last of them
// bwt_round_end: csrc order kKeysK .. kEndK, then the two timer words),
// sizes[5] the pinned words a round, sizes[6] this file's kernels a round
// (the graph body's), sizes[7] its kernels a call around the loop.
// Returns 0.
extern "C" int tpubz_bwt_sizes(int n, int* sizes) {
  const int cap = round_cap(n);
  sizes[0] = static_cast<int>(Layout(n, cap).bytes);
  sizes[1] = kPinnedPerRow;
  sizes[2] = cap;
  sizes[3] = kPasses;
  sizes[4] = kPinnedHead;
  sizes[5] = kPinnedPerRound;
  sizes[6] = kOwnPerRound;
  sizes[7] = kOwnPerCall;
  return 0;
}

// What a batched call of B rows of ns[b] bytes needs: sizes[0] the scratch's
// bytes (B rows at the stride of the longest), sizes[1] the pinned int32
// words (kPinnedPerRow a row), sizes[2] the most rows a call takes.
// Returns 0, or cudaErrorInvalidValue for B outside [1, kMaxRows].
extern "C" int tpubz_bwt_batch_sizes(const int* ns, int B, long long* sizes) {
  if (B < 1 || B > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  int n_max = 1;
  for (int b = 0; b < B; ++b) n_max = ns[b] > n_max ? ns[b] : n_max;
  sizes[0] = static_cast<long long>(B) * align256(Layout(n_max, round_cap(n_max)).bytes);
  sizes[1] = static_cast<long long>(B) * kPinnedPerRow;
  sizes[2] = kMaxRows;
  return 0;
}

// The BWT of B rows (1 <= B <= 32): row b is data[b * N : b * N + ns[b]],
// its key goes to key[b] and its column to last[b * N :]. ns: host ints,
// 0 <= ns[b] <= N, ns[b] <= 2^20; rows shorter than min_n take no round (1
// for the one-block call, 2 for the batch's pad rows). cap: a round cap
// below a row's own (round_cap) to hold every row to, or 0. scratch: device memory of the bytes
// tpubz_bwt_batch_sizes gives, 256-byte aligned. pinned: page-locked,
// card-addressable host int32 words, as many as it gives: row b's record at
// b * kPinnedPerRow (rounds, active rotations sorted, radix passes
// skipped, cap error, sorts, passes run, the body kernels' launches, which
// row 0 holds, the low words of %globaltimer at the start of bwt_setup and
// at the end of the row's bwt_last_column CTA 0), its round r's words after it (next active count,
// classes, split flag, next large count). Enqueues the whole call on
// `stream` and returns at once: the record is the card's once the stream
// has passed the call, and the scratch and the pinned words must live until
// then. stats (out, 5 ints): as enqueue_bwt. Returns cudaGetLastError() as
// an int, 0 on success; a row that reaches its cap short of the stop rule
// (which no input can cause) shows in its record.
extern "C" int tpubz_bwt_forward_batch(const void* data, const int* ns, int B, int N, int min_n,
                                       int cap, void* scratch,
                                       long long scratch_bytes_given, int* pinned, void* key,
                                       void* last, int* stats, void* stream) {
  return enqueue_bwt(static_cast<const uint8_t*>(data), ns, B, N, min_n, cap, scratch, scratch_bytes_given, pinned, static_cast<int64_t*>(key),
                     static_cast<uint8_t*>(last), stats, static_cast<cudaStream_t>(stream));
}

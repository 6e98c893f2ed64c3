// The whole forward BWT of one block on the card, in one library call:
// every doubling round (keys, their radix sort, re-rank and compaction), the
// stop test, the key and the last column.
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
// bits 0-19, on the LSD radix sort of csrc/radix.cuh.
//
//   bwt_keys          a round's keys, built straight into the radix sort's
//                     histogram launch: round 0 from the block's bytes (all
//                     n rotations), a later round from the active list and
//                     rank (rank[i] << 40 | rank[(i + h) mod n] << 20 | i).
//   radix_pass        one launch a digit of bits 20-59 (radix.cuh).
//   bwt_rank_tiles    one CTA per tile of 2048 sorted keys: its last class
//                     start, its last head, its heads, class starts and
//                     rotations that stay active.
//   bwt_rank_apply    one CTA per tile: every CTA adds up the tiles before
//                     it (at most 512, no look-back spin) and scans its own:
//                     key q's slot is g + q - (its class's first index), its
//                     rank its head's slot; rank[i], sa[slot] and the
//                     compacted next active list are written (the last two
//                     through shared memory, in tile order), and CTA 0,
//                     which has no tile before it, adds up all of them and
//                     writes the round's state.
//   bwt_last_column   last[p] = block[(sa[p] + n - 1) mod n], key = rank[0]:
//                     one gather, ties included (identical rotations).
//
// The stop test without a stall. The state lives on the device, a slot per
// round: m[r + 1] (the next round's active count) and done[r], written by
// round r's bwt_rank_apply. Every kernel of round r reads done[r - 1] and
// m[r] first and its CTAs past m[r] return at once, so the grids are sized
// for n. The host enqueues round r + 1, then sleeps on the event after
// round r and reads the round's words from pinned memory that round r's
// bwt_rank_apply wrote through the card's mapping of it: the card always
// has the next round queued, and after the last round it runs through one
// round of empty launches that write nothing. The rule: stop after a round
// that leaves no active rotation, or in which no active class split (the
// partition at 2h equals the one at h).
//
// The batched call (tpubz_bwt_forward_batch, the counterpart of tpubz's
// lax.map of bwt_forward(..., skip_converged="batch") in
// tpubz/dist/sharded.py) runs up to 32 rows, each with its own scratch at a
// fixed stride: its own state, active lists, rank, sa, histograms, tickets
// and status words, so the radix passes' (round, pass) tags stay unique
// within a row. Every kernel takes the rows of its launch as grid
// dimension y (radix.cuh's Rows) and finds its row's buffers at the row's
// offset; the host follows every row's state one round behind, and a
// round's launches cover only the rows still refining. A row of one byte
// (a pad row) takes no round. The one-block call is the batch of one row.
//
// What bounds it on an H100, per round of m active keys: the sort's passes
// at 16 bytes a key each (radix.cuh), the key build's gathers of rank and
// the re-rank's scatter of rank (32-byte sectors for 4-byte words), all
// inside the 50 MB L2; and the host's wake-up per round. The re-rank's
// writes of sa and of the next active list go out through shared memory,
// consecutive threads to consecutive slots, so that they fill whole sectors.
#include <cuda_runtime.h>

#include <chrono>
#include <cstdint>

#include "block_scan.cuh"
#include "radix.cuh"

namespace {

using tpubz::radix::at_row;
using tpubz::radix::Gate;
using tpubz::radix::gated_count;
using tpubz::radix::kDigitBits;
using tpubz::radix::kMaxRows;
using tpubz::radix::kTile;
using tpubz::radix::Rows;
using tpubz::radix::tiles_of;

constexpr int kThreads = 256;
constexpr int kRankPer = 8;  // sorted keys a thread of the re-rank holds
constexpr int kRankTile = kThreads * kRankPer;
constexpr int kMaxLog2 = 20;
constexpr int kMaxRankTiles = (1 << kMaxLog2) / kRankTile;
constexpr int kMaxRounds = 24;  // state slots; the round cap at 2^20 is 20
constexpr int kSeedBytes = 5;
constexpr int kKeyLo = kMaxLog2, kKeyHi = 3 * kMaxLog2;  // the sorted bits
constexpr int kPinnedPerRound = 3;  // next active count, classes, split
constexpr int kPinnedPerRow = kPinnedPerRound * kMaxRounds;
constexpr int64_t kPosMask = (1 << kMaxLog2) - 1;
constexpr int kAggs = 5;  // per re-rank tile: last class start, last head, heads, starts, active
constexpr int kPasses = tpubz::radix::passes_of(kKeyLo, kKeyHi);

size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

// The scratch: the two key buffers, rank, sa, the two active lists, the
// re-rank's tile aggregates, then the words zeroed once per call: the state
// (m[kMaxRounds + 1], done[kMaxRounds]), a ticket per round and pass, each
// round's histogram, the radix status words.
struct Layout {
  size_t keys[2], rank, sa, act[2], agg, zero, m, done, tickets, hist, status, bytes;
  Layout(int n, int cap) {
    const size_t n8 = align256(8 * static_cast<size_t>(n)), n4 = align256(4 * static_cast<size_t>(n));
    keys[0] = 0;
    keys[1] = n8;
    rank = 2 * n8;
    sa = rank + n4;
    act[0] = sa + n4;
    act[1] = act[0] + n4;
    agg = act[1] + n4;
    zero = agg + align256(4 * kAggs * kMaxRankTiles);
    m = zero;
    done = m + 4 * (kMaxRounds + 1);
    tickets = align256(done + 4 * kMaxRounds);
    hist = tickets + 4 * static_cast<size_t>(cap) * tpubz::radix::kMaxPasses;
    status = hist + (static_cast<size_t>(cap) * kPasses << kDigitBits) * 4;
    bytes = status + (static_cast<size_t>(tiles_of(n)) << kDigitBits) * 4;
  }
};

// (i + k) mod n for 0 <= i < n and 0 <= k < n: i + k < 2n <= 2^21
__device__ __forceinline__ int wrap(int i, int k, int n) {
  const int j = i + k;
  return j >= n ? j - n : j;
}

// The round's keys of the CTA's row, in active-list order (all n rotations
// in round 0, act == nullptr), and every digit's count. The row's block is
// data + row * N; rank, act, keys and hist are row 0's.
__global__ void __launch_bounds__(kThreads)
    bwt_keys(const uint8_t* __restrict__ data, int N, int round, const int32_t* __restrict__ rank,
             const int32_t* __restrict__ act, Gate gate, Rows rows, int64_t* __restrict__ keys,
             uint32_t* hist) {
  __shared__ uint32_t s_hist[kPasses << kDigitBits];
  const int m = gated_count(gate, rows);
  const int base = blockIdx.x * kTile;
  if (base >= m) return;
  const int n = rows.n[blockIdx.y];
  const uint8_t* block = data + static_cast<size_t>(rows.row[blockIdx.y]) * N;
  rank = at_row(rank, rows);
  act = at_row(act, rows);
  keys = at_row(keys, rows);
  hist = at_row(hist, rows);
  // the round's shift, reduced mod n
  const int h = round > 0 ? static_cast<int>((static_cast<long long>(kSeedBytes) << (round - 1)) % n) : 0;
  for (int x = threadIdx.x; x < kPasses << kDigitBits; x += kThreads) s_hist[x] = 0;
  __syncthreads();
#pragma unroll 4
  for (int j = 0; j < tpubz::radix::kPer; ++j) {
    const int q = base + j * kThreads + threadIdx.x;
    int64_t key = 0;
    if (q < m) {
      if (act == nullptr) {
        // the cyclic bytes from q on, whatever n is (n = 1: the byte again)
        uint64_t packed = 0;
        int i = q;
#pragma unroll
        for (int b = 0; b < kSeedBytes; ++b) {
          packed = (packed << 8) | block[i];
          i = i + 1 == n ? 0 : i + 1;
        }
        key = static_cast<int64_t>(packed << kMaxLog2) | q;
      } else {
        const int i = act[q];
        key = (static_cast<int64_t>(rank[i]) << (2 * kMaxLog2)) |
              (static_cast<int64_t>(rank[wrap(i, h, n)]) << kMaxLog2) | i;
      }
      keys[q] = key;
    }
    tpubz::radix::hist_add(s_hist, key, q < m, kKeyLo, kKeyHi);
  }
  tpubz::radix::hist_flush(s_hist, hist, kPasses);
}

// The flags of this thread's kRankPer sorted keys from `base` on (m keys in
// all): head (bits 20-59 differ from the key before; key 0 is one), class
// start (the old rank, bits 40-59 in rounds >= 1, differs; in round 0 all
// rotations are one class) and whether the key's new class has company.
struct Flags {
  int64_t key[kRankPer];
  bool head[kRankPer], start[kRankPer], active[kRankPer];
};

__device__ __forceinline__ void load_flags(const int64_t* __restrict__ skey, int base, int m,
                                           int round, Flags& f) {
  const int gshift = round > 0 ? 2 * kMaxLog2 : 63;  // round 0: g = 0 for every key
  int64_t prev = base > 0 && base <= m ? skey[base - 1] : 0;
  bool head_next = true;  // past the last key
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    const int idx = base + q;
    f.key[q] = idx < m ? skey[idx] : 0;
  }
  if (base + kRankPer < m) head_next = (skey[base + kRankPer] >> kKeyLo) != (f.key[kRankPer - 1] >> kKeyLo);
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    const int idx = base + q;
    const int64_t k = f.key[q];
    f.head[q] = idx < m && (idx == 0 || (k >> kKeyLo) != (prev >> kKeyLo));
    f.start[q] = idx < m && (idx == 0 || (k >> gshift) != (prev >> gshift));
    prev = k;
  }
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    const bool next = q + 1 < kRankPer ? (base + q + 1 >= m || f.head[q + 1]) : head_next;
    f.active[q] = base + q < m && !(f.head[q] && next);
  }
}

// agg[k * kMaxRankTiles + tile], k: last class start, last head (-1 if
// none), heads, class starts, active keys
__global__ void __launch_bounds__(kThreads)
    bwt_rank_tiles(const int64_t* __restrict__ skey, int round, Gate gate, Rows rows,
                   int32_t* __restrict__ agg) {
  __shared__ int sh[32];
  const int m = gated_count(gate, rows);
  if (blockIdx.x * kRankTile >= m) return;
  skey = at_row(skey, rows);
  agg = at_row(agg, rows);
  const int base = blockIdx.x * kRankTile + threadIdx.x * kRankPer;
  Flags f;
  load_flags(skey, base, m, round, f);
  int last_start = -1, last_head = -1, heads = 0, starts = 0, active = 0;
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    if (f.start[q]) last_start = base + q;
    if (f.head[q]) last_head = base + q;
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
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kAggs; ++k) agg[k * kMaxRankTiles + blockIdx.x] = out[k];
  }
}

// A tile index's word in the re-rank's shared arrays: one pad word every
// 32, so that neither the threads' runs of kRankPer nor a warp's 32
// consecutive indices share a bank.
__device__ __forceinline__ int padded(int x) { return x + (x >> 5); }
constexpr int kPaddedRankTile = kRankTile + kRankTile / 32;

// m_next and done: the state's slots; pinned: the card's address of the
// host's pinned words, kPinnedPerRound a round and kPinnedPerRow a row.
// Every pointer but pinned is row 0's.
__global__ void __launch_bounds__(kThreads)
    bwt_rank_apply(const int64_t* __restrict__ skey, int round, Gate gate, Rows rows,
                   const int32_t* __restrict__ agg, int32_t* __restrict__ rank,
                   int32_t* __restrict__ sa, int32_t* __restrict__ act_next, int32_t* m_next,
                   int32_t* done, int32_t* __restrict__ pinned) {
  __shared__ int sh[32];
  // per key of the tile: its position, its slot and its index in the next
  // active list (-1: it leaves the list)
  __shared__ int s_pos[kPaddedRankTile], s_slot[kPaddedRankTile], s_out[kPaddedRankTile];
  const int m = gated_count(gate, rows);
  if (blockIdx.x * kRankTile >= m) return;
  const int n = rows.n[blockIdx.y];
  skey = at_row(skey, rows);
  agg = at_row(agg, rows);
  rank = at_row(rank, rows);
  sa = at_row(sa, rows);
  act_next = at_row(act_next, rows);
  m_next = at_row(m_next, rows);
  done = at_row(done, rows);
  pinned += static_cast<size_t>(rows.row[blockIdx.y]) * kPinnedPerRow;
  int start_before = -1, head_before = -1, active_before = 0;
  if (blockIdx.x == 0) {
    // no tile before this one: the round's state from all of them
    const int tiles = (m + kRankTile - 1) / kRankTile;
    int heads = 0, starts = 0, active = 0;
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      heads += agg[2 * kMaxRankTiles + t];
      starts += agg[3 * kMaxRankTiles + t];
      active += agg[4 * kMaxRankTiles + t];
    }
    tpubz::block_exclusive(heads, 0, tpubz::Sum(), sh, &heads);
    tpubz::block_exclusive(starts, 0, tpubz::Sum(), sh, &starts);
    tpubz::block_exclusive(active, 0, tpubz::Sum(), sh, &active);
    if (threadIdx.x == 0) {
      const bool split = heads > starts;
      m_next[round + 1] = active;
      done[round] = active == 0 || !split;
      pinned[kPinnedPerRound * round] = active;
      pinned[kPinnedPerRound * round + 1] = n - m + heads;  // classes of all n rotations
      pinned[kPinnedPerRound * round + 2] = split;
    }
  } else {
    for (int t = threadIdx.x; t < static_cast<int>(blockIdx.x); t += kThreads) {
      start_before = max(start_before, agg[t]);
      head_before = max(head_before, agg[kMaxRankTiles + t]);
      active_before += agg[4 * kMaxRankTiles + t];
    }
    tpubz::block_exclusive(start_before, -1, tpubz::Max(), sh, &start_before);
    tpubz::block_exclusive(head_before, -1, tpubz::Max(), sh, &head_before);
    tpubz::block_exclusive(active_before, 0, tpubz::Sum(), sh, &active_before);
  }

  const int base = blockIdx.x * kRankTile + threadIdx.x * kRankPer;
  Flags f;
  load_flags(skey, base, m, round, f);
  int my_start = -1, my_head = -1, my_active = 0;
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    if (f.start[q]) my_start = base + q;
    if (f.head[q]) my_head = base + q;
    my_active += f.active[q];
  }
  int unused;
  int first = max(start_before, tpubz::block_exclusive(my_start, -1, tpubz::Max(), sh, &unused));
  int headq = max(head_before, tpubz::block_exclusive(my_head, -1, tpubz::Max(), sh, &unused));
  int out = active_before + tpubz::block_exclusive(my_active, 0, tpubz::Sum(), sh, &unused);
#pragma unroll
  for (int q = 0; q < kRankPer; ++q) {
    const int idx = base + q;
    if (idx < m) {
      if (f.start[q]) first = idx;
      if (f.head[q]) headq = idx;
      const int64_t k = f.key[q];
      const int i = static_cast<int>(k & kPosMask);
      const int g = round > 0 ? static_cast<int>(k >> (2 * kMaxLog2)) : 0;
      rank[i] = g + headq - first;
      const int x = padded(threadIdx.x * kRankPer + q);
      s_pos[x] = i;
      s_slot[x] = g + idx - first;
      s_out[x] = f.active[q] ? out++ : -1;
    }
  }
  __syncthreads();
  const int count = min(kRankTile, m - static_cast<int>(blockIdx.x) * kRankTile);
  for (int x = threadIdx.x; x < count; x += kThreads) {
    const int i = s_pos[padded(x)];
    sa[s_slot[padded(x)]] = i;
    const int o = s_out[padded(x)];
    if (o >= 0) act_next[o] = i;
  }
}

// Row b's column at last + b * N and its key at key[b]; sa and rank are
// row 0's. A row of one byte is its own column, key 0, whether or not it
// ran a round; a row of none is all zero.
__global__ void __launch_bounds__(kThreads)
    bwt_last_column(const uint8_t* __restrict__ data, int N, Rows rows,
                    const int32_t* __restrict__ sa, const int32_t* __restrict__ rank,
                    uint8_t* __restrict__ last, int64_t* __restrict__ key) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= N) return;
  const int n = rows.n[blockIdx.y];
  const size_t row = rows.row[blockIdx.y];
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
  const int i = at_row(sa, rows)[p];
  last[p] = block[i == 0 ? n - 1 : i - 1];
  if (p == 0) key[row] = at_row(rank, rows)[0];
}

int blocks_for(int lanes, int per) { return (lanes + per - 1) / per; }

// the two events of the one-round-ahead schedule, destroyed on every return
struct Events {
  cudaEvent_t ev[2] = {nullptr, nullptr};
  cudaError_t create() {
    // the waiting thread sleeps: its core is the emit threads' and the CPU
    // workers' meanwhile
    for (auto& e : ev) {
      const cudaError_t err =
          cudaEventCreateWithFlags(&e, cudaEventDisableTiming | cudaEventBlockingSync);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
  ~Events() {
    for (auto e : ev) {
      if (e != nullptr) cudaEventDestroy(e);
    }
  }
};

// The most doubling rounds a block of n bytes can need, plus one: round r
// compares kSeedBytes * 2^r bytes, and once that covers n the next round
// leaves no rotation active or splits no class.
int round_cap(int n) {
  int c = 0;
  while ((static_cast<long long>(kSeedBytes) << c) < n) ++c;
  return c + 2;
}

// The call behind tpubz_bwt_forward and tpubz_bwt_forward_batch, which
// describe the arguments: B rows of N bytes at data, row b's first ns[b]
// valid. Rows shorter than min_n take no round (the batch's pad rows).
int enqueue_bwt(const uint8_t* data, const int* ns, int B, int N, int min_n, void* scratch,
                long long scratch_bytes_given, int* pinned, int64_t* out_key, uint8_t* out_last,
                int* stats, cudaStream_t st) {
  using Clock = std::chrono::steady_clock;
  const auto us_since = [](Clock::time_point t) {
    return static_cast<int>(
        std::chrono::duration_cast<std::chrono::microseconds>(Clock::now() - t).count());
  };
  const auto t_call = Clock::now();
  for (int q = 0; q < 7; ++q) stats[q] = 0;
  stats[7] = -1;
  if (B < 1 || B > kMaxRows || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  int n_max = 1;
  for (int b = 0; b < B; ++b) {
    if (ns[b] < 0 || ns[b] > N || ns[b] > (1 << kMaxLog2)) return static_cast<int>(cudaErrorInvalidValue);
    n_max = ns[b] > n_max ? ns[b] : n_max;
  }
  const Layout L(n_max, round_cap(n_max));
  const size_t stride = align256(L.bytes);
  if (scratch_bytes_given < 0 ||
      static_cast<size_t>(scratch_bytes_given) < (B - 1) * stride + L.bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* b0 = static_cast<unsigned char*>(scratch);
  // row 0's buffers; each kernel moves them to its CTA's row
  const auto i64 = [&](size_t off) { return reinterpret_cast<int64_t*>(b0 + off); };
  const auto i32 = [&](size_t off) { return reinterpret_cast<int32_t*>(b0 + off); };
  const auto u32 = [&](size_t off) { return reinterpret_cast<uint32_t*>(b0 + off); };
  int64_t* const keys[2] = {i64(L.keys[0]), i64(L.keys[1])};
  int32_t* const act[2] = {i32(L.act[0]), i32(L.act[1])};
  int32_t* const m_state = i32(L.m);
  int32_t* const done = i32(L.done);
  Events events;
  if (cudaError_t e = events.create()) return static_cast<int>(e);
  int32_t* pinned_on_card = nullptr;
  if (cudaError_t e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&pinned_on_card), pinned,
                                               0)) {
    return static_cast<int>(e);
  }
  int& own_launches = stats[1];
  int& pass_launches = stats[2];
  int& enqueue_us = stats[4];
  int& wait_us = stats[5];

  // the rows that take rounds; the state, tickets, histograms and status
  // words of each: this call's tags only
  int live[kMaxRows], cap[kMaxRows];
  int nlive = 0;
  long long active_sorted = 0;
  for (int b = 0; b < B; ++b) {
    cap[b] = round_cap(ns[b] > 0 ? ns[b] : 1);
    if (ns[b] < min_n || ns[b] < 1) continue;
    live[nlive++] = b;
    active_sorted += ns[b];
    if (cudaError_t e = cudaMemsetAsync(b0 + b * stride + L.zero, 0, L.bytes - L.zero, st)) {
      return static_cast<int>(e);
    }
  }

  // one doubling round over the listed rows, and its event
  auto enqueue_round_untimed = [&](int r, const int* list, int count) -> int {
    Rows rows{};
    rows.stride = static_cast<long long>(stride);
    int widest = 1;
    for (int k = 0; k < count; ++k) {
      rows.row[k] = list[k];
      rows.n[k] = ns[list[k]];
      widest = rows.n[k] > widest ? rows.n[k] : widest;
    }
    const Gate gate{r > 0 ? done + (r - 1) : nullptr, r > 0 ? m_state + r : nullptr};
    uint32_t* hist = u32(L.hist) + (static_cast<size_t>(r) * kPasses << kDigitBits);
    int64_t* const in = keys[kPasses & 1];
    const int32_t* act_in = r > 0 ? act[r & 1] : nullptr;
    bwt_keys<<<dim3(tiles_of(widest), count), kThreads, 0, st>>>(data, N, r, i32(L.rank), act_in,
                                                                 gate, rows, in, hist);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    if (int rc = tpubz::radix::enqueue_passes(in, keys, kKeyLo, kKeyHi, hist, u32(L.status),
                                              u32(L.tickets) + r * tpubz::radix::kMaxPasses, r,
                                              gate, rows, count, tiles_of(widest), &pass_launches,
                                              st)) {
      return rc;
    }
    const dim3 rgrid(blocks_for(widest, kRankTile), count);
    bwt_rank_tiles<<<rgrid, kThreads, 0, st>>>(keys[0], r, gate, rows, i32(L.agg));
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    bwt_rank_apply<<<rgrid, kThreads, 0, st>>>(keys[0], r, gate, rows, i32(L.agg), i32(L.rank),
                                               i32(L.sa), act[(r + 1) & 1], m_state, done,
                                               pinned_on_card);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    own_launches += 3;
    return static_cast<int>(cudaEventRecord(events.ev[r & 1], st));
  };
  auto enqueue_round = [&](int r, const int* list, int count) -> int {
    const auto t = Clock::now();
    const int rc = enqueue_round_untimed(r, list, count);
    enqueue_us += us_since(t);
    return rc;
  };

  if (nlive > 0) {
    if (int rc = enqueue_round(0, live, nlive)) return rc;
  }
  for (int r = 0; nlive > 0; ++r) {
    // round r + 1 for the rows not known to have ended, below their cap
    int ahead[kMaxRows], nahead = 0;
    for (int k = 0; k < nlive; ++k) {
      if (r + 1 < cap[live[k]]) ahead[nahead++] = live[k];
    }
    if (nahead > 0) {
      if (int rc = enqueue_round(r + 1, ahead, nahead)) return rc;
    }
    const auto t_wait = Clock::now();
    if (cudaError_t e = cudaEventSynchronize(events.ev[r & 1])) return static_cast<int>(e);
    wait_us += us_since(t_wait);
    int still = 0;
    for (int k = 0; k < nlive; ++k) {
      const int b = live[k];
      const volatile int* words =
          static_cast<volatile int*>(pinned) + static_cast<size_t>(b) * kPinnedPerRow + kPinnedPerRound * r;
      const int m_after = words[0];
      if (m_after == 0 || words[2] == 0) {
        stats[0] += r + 1;
        continue;
      }
      if (r + 1 >= cap[b]) {
        stats[7] = b;
        return -1;
      }
      active_sorted += m_after;
      live[still++] = b;
    }
    nlive = still;
  }
  stats[3] = static_cast<int>(active_sorted);
  Rows all{};
  all.stride = static_cast<long long>(stride);
  for (int b = 0; b < B; ++b) {
    all.row[b] = b;
    all.n[b] = ns[b];
  }
  bwt_last_column<<<dim3(blocks_for(N, kThreads), B), kThreads, 0, st>>>(
      data, N, all, i32(L.sa), i32(L.rank), out_last, out_key);
  ++own_launches;
  stats[6] = us_since(t_call);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What a call for a block of n bytes needs, so that no caller repeats the
// layout: sizes[0] the scratch's bytes, sizes[1] the pinned int32 words,
// sizes[2] the round cap, sizes[3] the radix passes a round runs. Returns 0.
extern "C" int tpubz_bwt_sizes(int n, int* sizes) {
  const int cap = round_cap(n);
  sizes[0] = static_cast<int>(Layout(n, cap).bytes);
  sizes[1] = kPinnedPerRow;
  sizes[2] = cap;
  sizes[3] = kPasses;
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

// Enqueues the whole BWT of data[:n] on `stream` and returns when the last
// column is enqueued (it waits for each round's state, one round behind the
// card, asleep on the round's event).
//   data: device uint8[N], 1 <= n <= N, n <= 2^20. scratch: device memory
//   of at least the bytes tpubz_bwt_sizes gives, 256-byte aligned. pinned:
//   page-locked host int32 words, as many as tpubz_bwt_sizes gives, that the
//   card can address (cudaHostGetDevicePointer); round r leaves its next
//   active count, its classes and its split flag at 3r, 3r + 1, 3r + 2.
//   key: device int64; last: device uint8[N].
//   stats (out, 7 ints): rounds run, launches of this file's kernels, launches
//   of the radix passes (a skipped round's included), the active rotations
//   sorted (the sum over the rounds run), and the host's microseconds in the
//   call: enqueueing rounds, waiting for events, in all.
// Returns cudaGetLastError() as an int, 0 on success, or -1 when the sort
// had not converged at the round cap (which no input can cause). After any
// other return than 0 the stream has been drained: a round enqueued ahead
// may still have been writing the scratch and the pinned words, which the
// caller is now free to release.
extern "C" int tpubz_bwt_forward(const void* data, int n, int N, void* scratch,
                                 int scratch_bytes_given, int* pinned, void* key, void* last,
                                 int* stats, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int all_stats[8];
  const int rc = enqueue_bwt(static_cast<const uint8_t*>(data), &n, 1, N, 1, scratch,
                             scratch_bytes_given, pinned, static_cast<int64_t*>(key),
                             static_cast<uint8_t*>(last), all_stats, st);
  for (int q = 0; q < 7; ++q) stats[q] = all_stats[q];
  if (rc != 0) cudaStreamSynchronize(st);
  return rc;
}

// The BWT of B rows at once (1 <= B <= 32): row b is data[b * N : b * N +
// ns[b]], its key goes to key[b] and its column to last[b * N :]; each row
// equals tpubz_bwt_forward of that row. ns: host ints, 0 <= ns[b] <= N,
// ns[b] <= 2^20; a row of 0 or 1 bytes takes no round. scratch: device
// memory of the bytes tpubz_bwt_batch_sizes gives, 256-byte aligned.
// pinned: page-locked, card-addressable host int32 words, as many as it
// gives: row b's round r leaves its words at b * 72 + 3r. stats (out, 8
// ints): rounds run summed over the rows, launches of this file's kernels,
// launches of the radix passes, the active rotations sorted (over rows and
// rounds), the host's microseconds enqueueing, waiting and in all, and the
// row that reached its cap (-1 if none). Returns as tpubz_bwt_forward;
// -1 names its row in stats[7].
extern "C" int tpubz_bwt_forward_batch(const void* data, const int* ns, int B, int N,
                                       void* scratch, long long scratch_bytes_given, int* pinned,
                                       void* key, void* last, int* stats, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int rc = enqueue_bwt(static_cast<const uint8_t*>(data), ns, B, N, 2, scratch,
                             scratch_bytes_given, pinned, static_cast<int64_t*>(key),
                             static_cast<uint8_t*>(last), stats, st);
  if (rc != 0) cudaStreamSynchronize(st);
  return rc;
}

// The whole forward BWT of one block on the card, in one library call:
// the seed keys, every doubling round (key build, bitonic sort, re-rank),
// the stop test, the key and the last column.
//
// Replaces tpubz/kernels/suffix_sort.py:bwt_forward, an XLA program of
// tpubz's device chain (a fixed number of 4-key variadic sorts under
// lax.cond, shifts by concatenation, a cumsum of difference flags and a
// second sort for the last column: a TPU has no fast gather or scatter).
// Only its outputs are kept: key = the number of rotations strictly smaller
// than rotation 0, last[:n] = the BWT last column (periodic blocks
// included), last[n:] = 0. The formulation is this card's
// (tpubz_torch/kernels/suffix_sort.py describes it): 2-ary doubling on one
// packed int64 key per round, (rank[i] << 32) | rank[(i + k) mod n], sorted
// with its position by the network of csrc/bitonic.cu; ranks are int32 (the
// seed is 24 bits, later ranks are dense and < n <= 2^20).
//
//   bwt_seed_keys     round 0's keys straight from the bytes, the three
//                     cyclic bytes at i over the three at i + 3; pad lanes
//                     INT64_MAX; positions i.
//   bwt_round_keys    a later round's keys from rank; the shifted operand is
//                     a contiguous read from (i + k) mod n, so it coalesces.
//   bwt_rerank_count  one CTA per tile of 2048 sorted lanes: how many lanes
//                     differ from the lane before (the tile's new classes).
//   bwt_rerank        one CTA per tile: the tile's offset is the sum of the
//                     counts before it (at most 512, every CTA adds them up
//                     itself: no third launch and no look-back spin), a CTA
//                     scan gives cls(i), and rank[order[i]] = cls(i). Every
//                     CTA also knows the total, distinct = classes: when it
//                     equals the round before's, the partition did not
//                     change (classes only split) and the write is skipped,
//                     as the plain version skips it. It would be harmless:
//                     the old rank is dense, the new key's high field is the
//                     old rank, so an unchanged partition ordered by it
//                     gives every class its old index.
//   bwt_last_column   distinct == n: rank is a permutation, so
//                     last[rank[(j + 1) mod n]] = block[j] and key = rank[0].
//                     One scatter and no sort.
//   bwt_tie_keys,     distinct < n (periodic blocks): identical rotations
//   bwt_tie_gather    share their last byte, so the order by the next
//                     rotation's rank with ties in j order gives the column:
//                     a keys-only sort of (rank[(j+1) mod n] << 20) | j, then
//                     a gather; key = #(rank < rank[0]) by integer atomics.
//
// The stop test without a stall. The state lives on the device, one slot
// per round: distinct[r] and done[r], written by round r's bwt_rerank.
// Every kernel of round r, the bitonic pass kernels included, reads
// done[r-1] first and returns at once when it is set; nothing else reads a
// word that the same launch writes. The host enqueues round r+1, then waits
// for the event after round r and reads distinct[r] from a pinned word that
// round r's bwt_rerank wrote through the card's mapping of it, so the card
// always has the next round queued, and after the last round it runs
// through at most one round of empty launches, none of which writes: when
// the call returns, nothing queued touches the pinned words. The rule is
// the plain version's: stop after a round with distinct == n, or with
// distinct equal to the round before's.
//
// What bounds it on an H100: per round 8.4 MB of sorted keys and 4.2 MB of
// positions in, 3.6 MB of ranks out (scattered: 32-byte sectors), 7.2 MB of
// ranks in and 12.6 MB of keys and positions out: ~10 us at 3.35 TB/s
// beside a sort of ~290 us. The kernels are plain maps and one CTA scan; the
// work is in the sorts.
#include <cuda_runtime.h>

#include <chrono>
#include <climits>
#include <cstdint>

#include "bitonic.cuh"
#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;  // sorted lanes a thread of the re-rank holds
constexpr int kTile = kThreads * kPer;
constexpr int kMaxLog2 = 20;
constexpr int kMaxTiles = (1 << kMaxLog2) / kTile;
constexpr int kMaxRounds = 24;  // state slots; the round cap at 2^20 is 21
constexpr int64_t kPadKey = INT64_MAX;
constexpr unsigned kFull = 0xffffffffu;

// The scratch tensor: keys int64[Pa], positions int32[Pa], rank int32[Pa],
// tile counts int32[kMaxTiles], distinct int32[kMaxRounds], done
// int32[kMaxRounds]; Pa = max(P, 64) keeps every part 256-byte aligned.
struct Scratch {
  int64_t* keys;
  int32_t* positions;
  int32_t* rank;
  int32_t* tile_counts;
  int32_t* distinct;
  int32_t* done;
};

constexpr int kTailBytes = 4 * (kMaxTiles + 2 * kMaxRounds);

size_t scratch_bytes(int P) { return 16 * static_cast<size_t>(P < 64 ? 64 : P) + kTailBytes; }

Scratch carve(void* base, int P) {
  const size_t Pa = P < 64 ? 64 : P;
  auto* b = static_cast<unsigned char*>(base);
  Scratch s;
  s.keys = reinterpret_cast<int64_t*>(b);
  s.positions = reinterpret_cast<int32_t*>(b + 8 * Pa);
  s.rank = reinterpret_cast<int32_t*>(b + 12 * Pa);
  s.tile_counts = reinterpret_cast<int32_t*>(b + 16 * Pa);
  s.distinct = s.tile_counts + kMaxTiles;
  s.done = s.distinct + kMaxRounds;
  return s;
}

__device__ __forceinline__ bool is_done(const int32_t* done) {
  return done != nullptr && *done != 0;
}

// (i + k) mod n for 0 <= i < n and 0 <= k < n: i + k < 2n <= 2^21
__device__ __forceinline__ int wrap(int i, int k, int n) {
  const int j = i + k;
  return j >= n ? j - n : j;
}

__global__ void __launch_bounds__(kThreads)
    bwt_seed_keys(const uint8_t* __restrict__ block, int n, int P, int64_t* __restrict__ keys,
                  int32_t* __restrict__ positions) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  positions[i] = i;
  if (i >= n) {
    keys[i] = kPadKey;
    return;
  }
  // the six cyclic bytes from i on, whatever n is (n = 1: six times the byte)
  uint64_t packed = 0;
  int j = i;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    packed = (packed << (q == 3 ? 16 : 8)) | block[j];
    j = j + 1 == n ? 0 : j + 1;
  }
  keys[i] = static_cast<int64_t>(packed);
}

// k: the round's shift, already reduced mod n
__global__ void __launch_bounds__(kThreads)
    bwt_round_keys(const int32_t* __restrict__ rank, int n, int P, int k,
                   const int32_t* __restrict__ done, int64_t* __restrict__ keys,
                   int32_t* __restrict__ positions) {
  if (is_done(done)) return;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  positions[i] = i;  // the sort permuted its payload
  keys[i] = i < n ? (static_cast<int64_t>(rank[i]) << 32) |
                        static_cast<uint32_t>(rank[wrap(i, k, n)])
                  : kPadKey;
}

// This thread's kPer sorted lanes from `base` on: f[q] is 1 where lane
// base + q < n starts a new class (its key differs from the lane before;
// lane 0 starts none). Pad lanes, and the lanes of a buffer shorter than the
// tile, are never read.
__device__ __forceinline__ void load_flags(const int64_t* __restrict__ skey, int base, int n,
                                           int (&f)[kPer]) {
  int64_t prev = base > 0 && base <= n ? skey[base - 1] : 0;
  if (base + kPer <= n) {
    const longlong2* v = reinterpret_cast<const longlong2*>(skey + base);
#pragma unroll
    for (int q = 0; q < kPer; q += 2) {
      const longlong2 x = v[q / 2];
      f[q] = x.x != prev;
      f[q + 1] = x.y != x.x;
      prev = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      f[q] = 0;
      if (base + q < n) {
        const int64_t x = skey[base + q];
        f[q] = x != prev;
        prev = x;
      }
    }
  }
  if (base == 0) f[0] = 0;
}

__global__ void __launch_bounds__(kThreads)
    bwt_rerank_count(const int64_t* __restrict__ skey, int n, const int32_t* __restrict__ done,
                     int32_t* __restrict__ tile_counts) {
  __shared__ int sh[32];
  if (is_done(done)) return;
  int f[kPer];
  load_flags(skey, blockIdx.x * kTile + threadIdx.x * kPer, n, f);
  int count = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) count += f[q];
  int total;
  tpubz::block_exclusive(count, 0, tpubz::Sum(), sh, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// distinct and done: the state's slots, one per round; this launch reads
// slot round - 1 and writes slot round. host_distinct: the card's address
// of the host's pinned words, one per round.
__global__ void __launch_bounds__(kThreads)
    bwt_rerank(const int64_t* __restrict__ skey, const int32_t* __restrict__ order, int n,
               const int32_t* __restrict__ tile_counts, int round, int32_t* distinct,
               int32_t* done, int32_t* __restrict__ host_distinct, int32_t* __restrict__ rank) {
  __shared__ int sh[32];
  if (round > 0 && done[round - 1] != 0) return;
  int before = 0, all = 0;
  for (int t = threadIdx.x; t < gridDim.x; t += kThreads) {
    const int c = tile_counts[t];
    all += c;
    if (t < blockIdx.x) before += c;
  }
  int tile_before, classes;
  tpubz::block_exclusive(before, 0, tpubz::Sum(), sh, &tile_before);
  tpubz::block_exclusive(all, 0, tpubz::Sum(), sh, &classes);
  classes += 1;  // lane 0's class
  const int base = blockIdx.x * kTile + threadIdx.x * kPer;
  int f[kPer];
  load_flags(skey, base, n, f);
  int count = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) count += f[q];
  int unused;
  int cls = tpubz::block_exclusive(count, 0, tpubz::Sum(), sh, &unused) + tile_before;
  const bool stall = round > 0 && classes == distinct[round - 1];
  if (!stall) {
    // equal keys get equal classes whatever order the sort left them in
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (base + q < n) {
        cls += f[q];
        rank[order[base + q]] = cls;
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    distinct[round] = classes;
    done[round] = classes == n || stall;
    host_distinct[round] = classes;
  }
}

__global__ void __launch_bounds__(kThreads)
    bwt_last_column(const uint8_t* __restrict__ block, const int32_t* __restrict__ rank, int n,
                    int N, uint8_t* __restrict__ last, int64_t* __restrict__ key) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= N) return;
  if (j >= n) {
    last[j] = 0;
    return;
  }
  last[rank[wrap(j, 1 % n, n)]] = block[j];
  if (j == 0) *key = rank[0];
}

// *key is zero before the launch
__global__ void __launch_bounds__(kThreads)
    bwt_tie_keys(const int32_t* __restrict__ rank, int n, int P, int64_t* __restrict__ keys,
                 int64_t* __restrict__ key) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  int below = 0;
  if (j < P) {
    keys[j] = j < n ? (static_cast<int64_t>(rank[wrap(j, 1 % n, n)]) << kMaxLog2) | j : kPadKey;
    below = j < n && rank[j] < rank[0];
  }
  const unsigned votes = __ballot_sync(kFull, below);
  if ((threadIdx.x & 31) == 0 && votes) {
    atomicAdd(reinterpret_cast<unsigned long long*>(key),
              static_cast<unsigned long long>(__popc(votes)));
  }
}

__global__ void __launch_bounds__(kThreads)
    bwt_tie_gather(const uint8_t* __restrict__ block, const int64_t* __restrict__ sorted, int n,
                   int N, uint8_t* __restrict__ last) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  last[i] = i < n ? block[sorted[i] & ((1 << kMaxLog2) - 1)] : 0;
}

int blocks_for(int lanes) { return (lanes + kThreads - 1) / kThreads; }

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
// compares 3 * 2^(r+1) bytes, and once that covers n the next round stalls.
int round_cap(int n) {
  int c = 0;
  while ((3LL << c) < n) ++c;
  return c + 2;
}

// The call behind tpubz_bwt_forward, which describes the arguments.
int enqueue_bwt(const uint8_t* block, int n, int N, void* scratch, int scratch_bytes_given,
                int* pinned, const int* plan, int plan_len, int64_t* out_key, uint8_t* out_last,
                int* stats, cudaStream_t st) {
  using Clock = std::chrono::steady_clock;
  const auto us_since = [](Clock::time_point t) {
    return static_cast<int>(
        std::chrono::duration_cast<std::chrono::microseconds>(Clock::now() - t).count());
  };
  const auto t_call = Clock::now();
  for (int q = 0; q < 7; ++q) stats[q] = 0;
  if (n < 1 || n > N || n > (1 << kMaxLog2)) return static_cast<int>(cudaErrorInvalidValue);
  int P = 1;
  while (P < n) P <<= 1;
  if (static_cast<size_t>(scratch_bytes_given) < scratch_bytes(P)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scratch s = carve(scratch, P);
  const int cap = round_cap(n);
  const int tiles = (n + kTile - 1) / kTile;
  Events events;
  if (cudaError_t e = events.create()) return static_cast<int>(e);
  int32_t* pinned_on_card = nullptr;
  if (cudaError_t e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&pinned_on_card), pinned,
                                               0)) {
    return static_cast<int>(e);
  }
  int& pass_launches = stats[2];
  int& own_launches = stats[3];
  int& enqueue_us = stats[4];
  int& wait_us = stats[5];

  // one doubling round and its event
  auto enqueue_round_untimed = [&](int r) -> int {
    const int32_t* done = r > 0 ? s.done + (r - 1) : nullptr;
    if (r == 0) {
      bwt_seed_keys<<<blocks_for(P), kThreads, 0, st>>>(block, n, P, s.keys, s.positions);
    } else {
      const int k = static_cast<int>((3LL << r) % n);
      bwt_round_keys<<<blocks_for(P), kThreads, 0, st>>>(s.rank, n, P, k, done, s.keys,
                                                         s.positions);
    }
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    if (int rc = tpubz::bitonic_run_i64(s.keys, s.positions, P, plan, plan_len, &pass_launches,
                                        done, st)) {
      return rc;
    }
    bwt_rerank_count<<<tiles, kThreads, 0, st>>>(s.keys, n, done, s.tile_counts);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    bwt_rerank<<<tiles, kThreads, 0, st>>>(s.keys, s.positions, n, s.tile_counts, r, s.distinct,
                                           s.done, pinned_on_card, s.rank);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    own_launches += 3;
    return static_cast<int>(cudaEventRecord(events.ev[r & 1], st));
  };
  auto enqueue_round = [&](int r) -> int {
    const auto t = Clock::now();
    const int rc = enqueue_round_untimed(r);
    enqueue_us += us_since(t);
    return rc;
  };

  if (int rc = enqueue_round(0)) return rc;
  int r = 0, distinct = 0, prev = -1;
  for (;;) {
    const bool ahead = r + 1 < cap;
    if (ahead) {
      if (int rc = enqueue_round(r + 1)) return rc;
    }
    const auto t_wait = Clock::now();
    if (cudaError_t e = cudaEventSynchronize(events.ev[r & 1])) return static_cast<int>(e);
    wait_us += us_since(t_wait);
    distinct = static_cast<volatile int*>(pinned)[r];
    if (distinct == n || distinct == prev) break;
    if (!ahead) return -1;
    prev = distinct;
    ++r;
  }
  stats[0] = r + 1;

  if (distinct == n) {
    bwt_last_column<<<blocks_for(N), kThreads, 0, st>>>(block, s.rank, n, N, out_last, out_key);
    ++own_launches;
    stats[6] = us_since(t_call);
    return static_cast<int>(cudaGetLastError());
  }
  if (cudaError_t e = cudaMemsetAsync(out_key, 0, sizeof(int64_t), st)) return static_cast<int>(e);
  bwt_tie_keys<<<blocks_for(P), kThreads, 0, st>>>(s.rank, n, P, s.keys, out_key);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (int rc = tpubz::bitonic_run_i64(s.keys, nullptr, P, plan, plan_len, &pass_launches, nullptr,
                                      st)) {
    return rc;
  }
  stats[1] = 1;
  bwt_tie_gather<<<blocks_for(N), kThreads, 0, st>>>(block, s.keys, n, N, out_last);
  own_launches += 2;
  stats[6] = us_since(t_call);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What a call for a block of n bytes needs, so that no caller repeats the
// layout: sizes[0] the scratch's bytes, sizes[1] the pinned int32 words,
// sizes[2] the round cap. Returns 0.
extern "C" int tpubz_bwt_sizes(int n, int* sizes) {
  int P = 1;
  while (P < n) P <<= 1;
  sizes[0] = static_cast<int>(scratch_bytes(P));
  sizes[1] = kMaxRounds;
  sizes[2] = round_cap(n);
  return 0;
}

// Enqueues the whole BWT of data[:n] on `stream` and returns when the last
// column is enqueued (it waits for each round's class count, one round
// behind the card, asleep on the round's event).
//   data: device uint8[N], 1 <= n <= N, n <= 2^20. scratch: device memory
//   of at least the bytes tpubz_bwt_sizes gives, 256-byte aligned. pinned:
//   page-locked host int32 words, as many as tpubz_bwt_sizes gives, that the
//   card can address (cudaHostGetDevicePointer). plan: the encoded plan
//   (bitonic.py:encode) of the full sort of P keys, P the next power of two
//   >= n, run with the positions as payload in the rounds and keys only for
//   the tied last column. key: device int64; last: device uint8[N].
//   stats (out, 7 ints): rounds run, keys-only sorts, launches of the
//   bitonic pass kernels (a skipped round's included), launches of this
//   file's kernels, and the host's microseconds in the call: enqueueing
//   rounds, waiting for events, in all.
// Returns cudaGetLastError() as an int, 0 on success, or -1 when the sort
// had not converged at the round cap (which no input can cause). After any
// other return than 0 the stream has been drained: a round enqueued ahead
// may still have been writing the scratch and the pinned words, which the
// caller is now free to release.
extern "C" int tpubz_bwt_forward(const void* data, int n, int N, void* scratch,
                                 int scratch_bytes_given, int* pinned, const int* plan,
                                 int plan_len, void* key, void* last, int* stats, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int rc = enqueue_bwt(static_cast<const uint8_t*>(data), n, N, scratch,
                             scratch_bytes_given, pinned, plan, plan_len,
                             static_cast<int64_t*>(key), static_cast<uint8_t*>(last), stats, st);
  if (rc != 0) cudaStreamSynchronize(st);
  return rc;
}

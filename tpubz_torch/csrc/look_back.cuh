// Decoupled look-back with no memset, shared by the kernels that cut their
// input into tiles and publish a count a tile (csrc/bitpack.cu,
// csrc/compact.cu).
//
// A call's scratch is the stream's (kernels/look_back.py keeps one a stream
// and device): a ticket word, then status words, a 64-bit word a tile. They
// are zeroed once, when the scratch is allocated, and never again:
//   - the ticket is taken with atomicInc(ticket, ctas - 1), which wraps
//     back to 0 with the call's last CTA, so every call finds it at 0;
//   - a status word carries the call's epoch (bits 38-63, 1 to kEpochMax,
//     the previous call's epoch + 1 and back to 1 after kEpochMax), its
//     flag (bits 36-37: 1 the tile's own count, 2 the count of every tile up
//     to it) and the count (bits 0-35). A word of another epoch, or 0, is
//     not yet published;
//   - after a call, every status word that the call did not publish is 0:
//     its CTAs zero the words from the first it does not publish up to the
//     previous call's reach (`dirty`, the host's bound on the words that
//     call used). So a word holds at most the previous call's epoch, never
//     this one's, and an epoch that comes round again meets no stale word.
// Calls on one stream run in order, so no two calls share a word at once.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tpubz {

using Status = unsigned long long;
constexpr int kEpochShift = 38;
constexpr unsigned kEpochMax = (1u << 26) - 1;
constexpr Status kStatusValue = (1ull << 36) - 1;
constexpr Status kStatusFlags = 3ull << 36;
constexpr Status kAggregate = 1ull << 36;
constexpr Status kInclusive = 2ull << 36;

// A call's view of the stream's scratch.
struct TileScratch {
  unsigned* ticket;  // 0 between calls
  Status* status;    // a word a tile
  unsigned epoch;    // this call's, 1..kEpochMax
  long long dirty;   // status words at or past it are 0 before the call
};

__device__ __forceinline__ Status ld_relaxed(const Status* p) {
  Status v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ Status ld_acquire(const Status* p) {
  Status v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <bool kAcquire>
__device__ __forceinline__ Status ld_status(const Status* p) {
  if constexpr (kAcquire) {
    return ld_acquire(p);
  } else {
    return ld_relaxed(p);
  }
}

__device__ __forceinline__ void st_relaxed(Status* p, Status v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A status word published as a release at the card's scope: after a CTA
// barrier it releases every thread's earlier writes, and what the CTA
// acquired (a fence and a relaxed store measured no faster on an H100:
// PERF.md §6).
__device__ __forceinline__ void st_release(Status* p, Status v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ Status status_word(unsigned epoch, Status flag, long long value) {
  return static_cast<Status>(epoch) << kEpochShift | flag | static_cast<Status>(value);
}

__device__ __forceinline__ bool published(Status w, unsigned epoch) {
  return (w >> kEpochShift) == epoch;
}

// The CTA's place among the call's `ctas` CTAs, in the order they start
// (called by one thread): the CTAs before it already run.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket, unsigned ctas) {
  return atomicInc(ticket, ctas - 1);
}

// Zero the status words [from, dirty), spread over the call's CTAs (`cta`
// this CTA's ticket); no tile of the call reads them.
__device__ __forceinline__ void clear_stale(Status* status, long long from, long long dirty,
                                            unsigned cta, unsigned ctas) {
  const long long step = static_cast<long long>(ctas) * blockDim.x;
  for (long long i = from + static_cast<long long>(cta) * blockDim.x + threadIdx.x; i < dirty;
       i += step) {
    status[i] = 0;
  }
}

// Lane l's word of the first look-back window of tile `tile` > 0: tile
// tile - 1 - l's, or an inclusive 0 before tile 0 (an acquire load with
// kAcquire, as warp_look_back's).
template <bool kAcquire>
__device__ __forceinline__ Status first_status(const Status* status, int tile, unsigned epoch) {
  const int src = tile - 1 - static_cast<int>(threadIdx.x & 31);
  return src < 0 ? status_word(epoch, kInclusive, 0) : ld_status<kAcquire>(status + src);
}

// The count of every tile before `tile` (> 0), in every lane of the calling
// warp (one whole warp). A window is kWindow words a lane, 32 * kWindow
// tiles: word j of lane l is tile t0 - 32 j - l's, so that one window
// reaches back over a level-9 row's or a 2^20-field call's every tile (220
// and 256). The warp loads the whole window at once and reloads, all at
// once, every word not yet published, until each word from the nearest
// back to the nearest inclusive count is published (one round trip to the
// L2 a poll, however far back that count lies); then it adds the counts up
// to it. Without an inclusive count in the window it moves back a window.
// `w`: first_status's word, the window's first. With kAcquire every load is
// an acquire, so that what the tiles before released with their status
// words (csrc/bitpack.cu: their zeroed words) is visible to the CTA after a
// barrier, and a release store after it passes it on.
constexpr int kWindow = 1;

template <bool kAcquire>
__device__ long long warp_look_back(const Status* status, int tile, unsigned epoch, Status w) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  long long sum = 0;
  for (int t0 = tile - 1;; t0 -= 32 * kWindow) {
    Status words[kWindow];
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
      const int src = t0 - 32 * j - lane;
      words[j] = src < 0 ? status_word(epoch, kInclusive, 0)
                 : j == 0 && t0 == tile - 1 ? w
                                            : ld_status<kAcquire>(status + src);
    }
    int stop;  // the 32 words that hold the nearest inclusive count, or kWindow
    for (;;) {
      bool ready = true;
      stop = kWindow;
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        if (ready && stop == kWindow) {
          const bool pub = published(words[j], epoch);
          const unsigned have = __ballot_sync(kFull, pub);
          const unsigned incl =
              __ballot_sync(kFull, pub && (words[j] & kStatusFlags) == kInclusive);
          const int k = incl ? __ffs(incl) - 1 : 31;  // lanes 0..k are needed
          const unsigned need = k == 31 ? kFull : (2u << k) - 1;
          if ((have & need) != need) {
            ready = false;
          } else if (incl) {
            stop = j;
          }
        }
      }
      if (ready) break;
      __nanosleep(20);
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        const int src = t0 - 32 * j - lane;
        if (!published(words[j], epoch)) words[j] = ld_status<kAcquire>(status + src);
      }
    }
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
      if (j <= stop) {
        const unsigned incl = __ballot_sync(kFull, (words[j] & kStatusFlags) == kInclusive);
        const int k = j == stop ? __ffs(incl) - 1 : 31;
        long long v = lane <= k ? static_cast<long long>(words[j] & kStatusValue) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
        sum += v;
      }
    }
    if (stop < kWindow) return sum;
  }
}

}  // namespace tpubz

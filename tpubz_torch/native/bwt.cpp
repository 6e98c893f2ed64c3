// Native host block transform: BWT (rotation sort) + MTF + RLE2.
//
// The CPU engine's counterpart of the port's device transforms
// (tpubz_torch/kernels/suffix_sort.py, mtf.py, rle2.py): it encodes whole
// blocks in the hybrid's CPU pool and in compress_cpu, so it must be
// competitive with C bzip2.
//
// BWT: SA-IS (linear-time suffix array by induced sorting, written from the
// textbook algorithm) over T = the lexicographically minimal rotation of S
// (two-pointer least-rotation, O(n) time O(1) space): for the minimal
// rotation, suffix order equals rotation order — the same property the
// reference exploits (sais_fallback.rs:582-620), so the SA-IS input is n
// bytes, not the doubled 2n. Identical rotations exist only when the block
// is fully periodic (smallest period p divides n); suffix order puts each
// tie class {m, m+p, ...} shortest-suffix-first, which maps to an arbitrary
// S-index order after rotation — each class run is rewritten ascending
// (m, m+p, ...) in closed form, matching the hostref and device engines
// bit-for-bit (they break rank ties by index). Validated against the
// hostref oracle on 8.6k brute-force cases incl. all-periodic regimes.
//
// SA-IS memory-layout note: split-array, implicit-sentinel form (see the
// block comment above sais_split) — values are the raw input (u8 at the
// top level, L2-resident per 900k block), types a 1-bit-per-position
// bitmap; the induce passes issue the two random reads in parallel. A
// fused (value<<1|type) u16 string (r4) and libsais-style sign-bit entry
// marking were both measured slower on this machine (PERFORMANCE.md
// "r5 CPU-engine round" / "r5 negative").
//
// MTF+RLE2: the serial scan with the roll-while-searching list update and
// bijective base-2 zero runs (semantics of src/tools/rle2_mtf.rs:23-177).

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <vector>
#include <algorithm>
#ifdef __AVX2__
#include <immintrin.h>
#endif

// The SWAR fast paths (MTF head-word shift, ctz-based first-diff-byte) and
// the decode-side word tricks assume little-endian byte order; on another
// host the build fails and the loader (native/__init__.py) raises.
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "tpubz native engine assumes a little-endian host"
#endif

// Optional per-phase accounting for tools/bwt_microbench.cpp — compiled
// out of the production .so (no TPUBZ_BWT_PROF in the build flags).
#ifdef TPUBZ_BWT_PROF
#include <chrono>
#include <cstdio>
namespace {
double g_prof[10];
inline double prof_now() {
  using namespace std::chrono;
  return duration<double, std::milli>(
             steady_clock::now().time_since_epoch())
      .count();
}
struct ProfScope {
  int slot;
  double t0;
  explicit ProfScope(int s) : slot(s), t0(prof_now()) {}
  ~ProfScope() { g_prof[slot] += prof_now() - t0; }
};
#define TPUBZ_PROF(slot) ProfScope _prof_scope_##__LINE__(slot)
}  // namespace
extern "C" void tpubz_bwt_prof_dump() {
  static const char* names[10] = {
      "least_rot", "build_sv", "fill+pass1", "induce1", "naming",
      "reduce",    "pass2",    "induce2",    "period",  "lastcol"};
  double tot = 0;
  for (int i = 0; i < 10; ++i) tot += g_prof[i];
  printf("bwt phase totals (all blocks x reps, recursion folded in):\n");
  for (int i = 0; i < 10; ++i)
    printf("  %-10s %8.1f ms (%4.1f%%)\n", names[i], g_prof[i],
           100.0 * g_prof[i] / tot);
}
#else
#define TPUBZ_PROF(slot) ((void)0)
#endif

namespace {

// Grow-only per-thread bump arena for the SA-IS per-level scratch (cnt,
// bkt, lms, name, sa1, sv1). Sized once before the recursion (total need
// is < 6n+O(1) ints — each level allocates <= 2K + 2*n_l + 1 ints and
// n_l <= n/2^l), so pointers stay stable across nested alloc calls.
// Memory is handed out DIRTY: every consumer below either writes each
// slot before reading it or zeroes explicitly — this removes ~4-6 MB of
// per-block fill traffic (the old std::vector zero/-1 inits) plus the
// alloc/free churn of the recursion.
struct Arena {
  std::vector<int32_t> buf;
  size_t top = 0;
  void prepare(size_t total) {
    if (buf.size() < total) buf.resize(total);
    top = 0;
  }
  int32_t* alloc(size_t k) {
    // growing here would invalidate live pointers up the recursion —
    // prepare() must have sized the arena; fail loudly over silent UB
    if (top + k > buf.size()) std::abort();
    int32_t* p = buf.data() + top;
    top += k;
    return p;
  }
  // 8-byte-aligned variant (the LMS bitmap is accessed as u64 words; the
  // vector's base is allocator-aligned, so an even int32 offset suffices)
  int32_t* alloc8(size_t k) {
    top = (top + 1) & ~(size_t)1;
    return alloc(k + (k & 1));
  }
  void release(size_t k) { top -= k; }
};

// ---------------------------------------------------------------------------
// SA-IS, split-array / implicit-sentinel form.
//
// Values and types live in SEPARATE structures: the value array is the raw
// input itself (u8 at the top level — the block text with NO +1 shift, NO
// appended sentinel, NO copy), and types are a 1-bit-per-position bitmap
// (n/8 bytes, L1/L2-resident). The empty suffix is implicit: standard
// suffix order ("a" < "ab") IS sentinel-terminated order, suffix n-1 is
// always the first entry of its bucket's L region and is seeded there
// manually before each L-scan (the role the explicit sentinel's induce
// step used to play). Compared to the previous fused (value<<1|type) u16
// string this halves the induce scans' random-read footprint (900 KB vs
// 1.8 MB per 900k block — the value array now fits L2) and lets the
// naming loop compare raw bytes.
// ---------------------------------------------------------------------------

// Type bitmap: bit i = 1 iff suffix i is S-type (ty[i] = V[i] < V[i+1] or
// (V[i] == V[i+1] and ty[i+1])); ty[n-1] = L. Scalar fallback for the
// recursion levels' integer alphabets.
template <typename ValT>
void build_types(const ValT* V, int32_t n, uint64_t* ty) {
  int32_t nbw = (n + 63) >> 6;
  std::memset(ty, 0, (size_t)nbw * 8);
  uint8_t t = 0;  // ty[n-1] = L
  for (int32_t i = n - 2; i >= 0; --i) {
    t = (V[i] < V[i + 1]) || (V[i] == V[i + 1] && t);
    ty[(uint32_t)i >> 6] |= (uint64_t)t << (i & 63);
  }
}

#ifdef __AVX512BW__
// u8 fast path: per 64-byte word, lt/eq masks from two compares, then the
// serial ty recurrence ty[i] = lt[i] | (eq[i] & ty[i+1]) is closed by a
// log-doubling smear (pull resolved values from 1,2,4,...,32 above; the
// fill mask F tracks all-eq runs so unresolved zeros never corrupt a
// resolved bit), with the word's top all-eq run taking the carry from the
// word above. Words are processed high-to-low; no serial chain per byte.
void build_types(const uint8_t* V, int32_t n, uint64_t* ty) {
  int32_t nw = (n - 1) >> 6;  // word containing position n-1
  // scalar fringe: positions [nw*64, n-1]
  uint64_t w = 0;
  uint8_t t = 0;
  for (int32_t i = n - 1; i >= nw << 6; --i) {
    if (i < n - 1) t = (V[i] < V[i + 1]) || (V[i] == V[i + 1] && t);
    w |= (uint64_t)t << (i & 63);
  }
  ty[nw] = w;
  uint64_t carry_ty = w & 1;
  for (int32_t wd = nw - 1; wd >= 0; --wd) {
    const uint8_t* p = V + ((int64_t)wd << 6);
    __m512i a = _mm512_loadu_si512(p);
    __m512i b = _mm512_loadu_si512(p + 1);
    uint64_t lt = _mm512_cmplt_epu8_mask(a, b);
    uint64_t eq = _mm512_cmpeq_epi8_mask(a, b);
    uint64_t T;
    if (eq == ~0ull) {
      T = carry_ty ? ~0ull : 0ull;
    } else {
      uint64_t F = eq;
      T = lt;
      T |= F & (T >> 1), F &= F >> 1;
      T |= F & (T >> 2), F &= F >> 2;
      T |= F & (T >> 4), F &= F >> 4;
      T |= F & (T >> 8), F &= F >> 8;
      T |= F & (T >> 16), F &= F >> 16;
      T |= F & (T >> 32);
      if (carry_ty) {
        int hb = 63 - __builtin_clzll(~eq);  // highest non-eq position
        if (hb < 63) T |= eq & (~0ull << (hb + 1));
      }
    }
    ty[wd] = T;
    carry_ty = T & 1;
  }
}
#endif

// SA-IS over V[0..n), values in [0, K), standard suffix order. sa gets the
// full suffix array. V must have >= 8 bytes of readable tail padding (the
// naming loop's word compares overread).
#ifndef TPUBZ_INDUCE_PD
#define TPUBZ_INDUCE_PD 24
#endif
template <typename ValT>
void sais_split(const ValT* V, int32_t* sa, int32_t n, int32_t K,
                Arena& ar) {
  if (n <= 1) {
    if (n == 1) sa[0] = 0;
    return;
  }
  size_t ar_mark = ar.top;
  int32_t* cnt = ar.alloc(K);
  int32_t* bkt = ar.alloc(K);  // fully written by bkt_heads/tails
  std::memset(cnt, 0, (size_t)K * sizeof(int32_t));
  for (int32_t i = 0; i < n; ++i) cnt[V[i]]++;
  auto bkt_tails = [&]() {
    int32_t sum = 0;
    for (int32_t c = 0; c < K; ++c) {
      sum += cnt[c];
      bkt[c] = sum;
    }
  };
  auto bkt_heads = [&]() {
    int32_t sum = 0;
    for (int32_t c = 0; c < K; ++c) {
      bkt[c] = sum;
      sum += cnt[c];
    }
  };

  int32_t nbw = (n >> 6) + 1;
  uint64_t* ty = reinterpret_cast<uint64_t*>(ar.alloc8(2 * nbw));
  {
    TPUBZ_PROF(1);
    build_types(V, n, ty);
  }
  auto stype = [&](int32_t i) {
    return (ty[(uint32_t)i >> 6] >> (i & 63)) & 1;
  };

  // The induce scans are latency-bound on the random V[j-1]/type reads (j
  // jumps with suffix order); sa itself is read sequentially, so upcoming
  // targets are known PD iterations early — prefetch them. The L-scan
  // seeds suffix n-1 (always L, always first in its bucket by the
  // shorter-suffix-first rule) at its bucket head: that is the induce
  // step the explicit sentinel used to perform.
  constexpr int32_t PD = TPUBZ_INDUCE_PD;
  auto induce = [&]() {
    bkt_heads();
    sa[bkt[V[n - 1]]++] = n - 1;
    for (int32_t i = 0; i < n; ++i) {
      if (i + PD < n) {
        int32_t jp = sa[i + PD];
        if (jp > 0) {
          __builtin_prefetch(&V[jp - 1]);
          __builtin_prefetch(&ty[(uint32_t)(jp - 1) >> 6]);
        }
      }
      int32_t j = sa[i];
      if (j > 0) {
        int32_t e = j - 1;
        if (!stype(e)) sa[bkt[V[e]]++] = e;
      }
    }
    bkt_tails();
    for (int32_t i = n - 1; i >= 0; --i) {
      if (i - PD >= 0) {
        int32_t jp = sa[i - PD];
        if (jp > 0) {
          __builtin_prefetch(&V[jp - 1]);
          __builtin_prefetch(&ty[(uint32_t)(jp - 1) >> 6]);
        }
      }
      int32_t j = sa[i];
      if (j > 0) {
        int32_t e = j - 1;
        if (stype(e)) sa[--bkt[V[e]]] = e;
      }
    }
  };

  // pass 1: LMS suffixes at bucket tails (any order), induce to sort the
  // LMS *substrings*. Word-wise LMS scan straight off the type bitmap:
  // lms = ty & ~(ty<<1 | carry); the mask word doubles as the bitmap the
  // naming loop probes. plen[pos>>1] = substring length (distance to the
  // next LMS; LMS positions are never adjacent so pos>>1 is collision-
  // free); the LAST LMS has no terminating LMS — its substring runs to
  // n-1, it is unique by construction, and naming guards it explicitly.
  int32_t lms_cap = n / 2 + 1;
  int32_t* lms_buf = ar.alloc(lms_cap);
  int32_t* plen = ar.alloc(lms_cap);
  uint64_t* lmsbit = reinterpret_cast<uint64_t*>(ar.alloc8(2 * nbw));
  int32_t m = 0;
  {
    TPUBZ_PROF(2);
    std::fill(sa, sa + n, -1);
    bkt_tails();
    int32_t nw = n >> 6;
    int32_t prev_pos = -1;
    uint64_t carry = 1;  // position 0 can never be LMS
    for (int32_t w = 0; w < nw; ++w) {
      uint64_t tyw = ty[w];
      uint64_t lm = tyw & ~((tyw << 1) | carry);
      carry = tyw >> 63;
      lmsbit[w] = lm;
      int32_t base = w << 6;
      while (lm) {
        int32_t pos = base + (int32_t)__builtin_ctzll(lm);
        lm &= lm - 1;
        sa[--bkt[V[pos]]] = pos;
        lms_buf[m++] = pos;
        if (prev_pos >= 0) plen[prev_pos >> 1] = pos - prev_pos;
        prev_pos = pos;
      }
    }
    uint64_t tail_lms = 0;
    uint64_t prev_ty = carry;
    for (int32_t i = nw << 6; i < n; ++i) {
      uint64_t t_ = stype(i);
      if (t_ && !prev_ty) {
        tail_lms |= 1ull << (i & 63);
        sa[--bkt[V[i]]] = i;
        lms_buf[m++] = i;
        if (prev_pos >= 0) plen[prev_pos >> 1] = i - prev_pos;
        prev_pos = i;
      }
      prev_ty = t_;
    }
    if (n & 63) lmsbit[nw] = tail_lms;
    if (prev_pos >= 0) plen[prev_pos >> 1] = 0;  // last LMS: guarded below
  }
  const int32_t* lms = lms_buf;  // LMS positions in index order
  int32_t last_lms = m > 0 ? lms_buf[m - 1] : -1;
  {
    TPUBZ_PROF(3);
    induce();
  }

  // name LMS substrings in their sorted order (name[] indexed pos>>1,
  // collision-free). Two LMS substrings are equal iff their lengths match
  // AND their VALUES over [0, len] match: both terminals are LMS (S-type),
  // and interior types are determined backward from the terminal by the
  // values alone, so a raw value compare — plain bytes at the top level —
  // is exact. The last LMS substring (terminal = end of string) matches
  // nothing else by construction and is forced different explicitly.
  int32_t* name = ar.alloc(n / 2 + 1);
  int32_t names = 0;
  int32_t prev = -1;
  {
    TPUBZ_PROF(4);
    int32_t lp = 0;
    for (int32_t i = 0; i < n; ++i) {
      int32_t cur = sa[i];
      if (!((lmsbit[(uint32_t)cur >> 6] >> (cur & 63)) & 1)) continue;
      int32_t lc = plen[cur >> 1];
      bool differ;
      if (prev < 0 || lp != lc || cur == last_lms || prev == last_lms) {
        differ = true;
      } else {
        const char* a = reinterpret_cast<const char*>(V + prev);
        const char* b = reinterpret_cast<const char*>(V + cur);
        size_t bytes = ((size_t)lc + 1) * sizeof(ValT);
        uint64_t wa, wb;
        std::memcpy(&wa, a, 8);
        std::memcpy(&wb, b, 8);
        if (bytes <= 8) {
          uint64_t diff = wa ^ wb;
          differ = bytes == 8
                       ? diff != 0
                       : (diff & ((1ull << (8 * bytes)) - 1)) != 0;
        } else {
          differ = wa != wb;
          size_t d = 8;
          for (; !differ && d + 8 <= bytes; d += 8) {
            std::memcpy(&wa, a + d, 8);
            std::memcpy(&wb, b + d, 8);
            differ = wa != wb;
          }
          if (!differ && d < bytes) {
            std::memcpy(&wa, a + d, 8);
            std::memcpy(&wb, b + d, 8);
            differ = ((wa ^ wb) & ((1ull << (8 * (bytes - d))) - 1)) != 0;
          }
        }
      }
      if (differ) names++;
      name[cur >> 1] = names - 1;
      prev = cur;
      lp = lc;
    }
  }

  // reduced problem: names in LMS index order, values in [0, names), no
  // sentinel (the recursion is the same implicit-sentinel algorithm).
  // sa1 and V1 are fully written before any read, so dirty arena memory
  // is safe. +4 int32 tail padding for the naming overreads.
  int32_t* sa1 = ar.alloc(m);
  if (names < m) {
    auto build_and_recurse = [&](auto* V1) {
      using T1 = std::remove_reference_t<decltype(*V1)>;
      {
        TPUBZ_PROF(5);
        for (int32_t k = 0; k < m; ++k) V1[k] = (T1)name[lms[k] >> 1];
      }
      sais_split<T1>(V1, sa1, m, names, ar);
    };
    if (names <= (1 << 16)) {
      int32_t* raw = ar.alloc((m + 1) / 2 + 4);
      build_and_recurse(reinterpret_cast<uint16_t*>(raw));
      ar.release((m + 1) / 2 + 4);
    } else {
      int32_t* V1 = ar.alloc(m + 4);
      build_and_recurse(V1);
      ar.release(m + 4);
    }
  } else {
    for (int32_t k = 0; k < m; ++k) sa1[name[lms[k] >> 1]] = k;
  }

  // pass 2: LMS suffixes at bucket tails in their true sorted order, induce
  {
    TPUBZ_PROF(6);
    std::fill(sa, sa + n, -1);
    bkt_tails();
    for (int32_t k = m - 1; k >= 0; --k) {
      int32_t j = lms[sa1[k]];
      sa[--bkt[V[j]]] = j;
    }
  }
  {
    TPUBZ_PROF(7);
    induce();
  }
  ar.top = ar_mark;  // pop this level's scratch
}

// Per-thread scratch reused across blocks: the top-level arrays total
// ~6.5 MB per 900k block, and fresh vector allocations would pay mmap
// page faults + kernel zeroing on every call (the block pools are
// long-lived threads, so the arrays are hot after the first block).
thread_local std::vector<uint8_t> tl_T;
thread_local std::vector<int32_t> tl_sa;
thread_local Arena tl_arena;

// Suffix array of a byte string (used directly as the value array — no
// shifted copy, no sentinel element). Returns a pointer into thread-local
// scratch, valid until the next call on this thread: entry i is the start
// of the i-th smallest suffix. t must have >= 8 bytes of tail padding.
const int32_t* sais_u8(const uint8_t* t, int32_t n) {
  if ((int32_t)tl_sa.size() < n) tl_sa.resize(n);
  // per-level simultaneous scratch is <= 2K + 2.7n_l + O(1) ints (lms,
  // plen, name at n_l/2+1 each, two bitmaps at n_l/32, sa1+V1 <= n_l)
  // with n_{l+1} <= n_l/2, so 10n+8192 bounds the whole recursion
  tl_arena.prepare((size_t)n * 10 + 8192);
  sais_split<uint8_t>(t, tl_sa.data(), n, 256, tl_arena);
  return tl_sa.data();
}

// Start index of the lexicographically minimal rotation: the classic
// two-pointer "minimum expression" duel, O(n) time, O(1) space (the
// reference reaches the same rotation via Duval factorization,
// sais_fallback.rs:781-816).
int32_t least_rotation(const uint8_t* s, int32_t n) {
  int32_t i = 0, j = 1, k = 0;
  while (i < n && j < n && k < n) {
    int32_t ik = i + k, jk = j + k;
    if (ik >= n) ik -= n;
    if (jk >= n) jk -= n;
#ifdef __AVX2__
    // bulk-advance over the equal prefix, but only once the scalar duel
    // has already matched 16 bytes (long-match regime): on high-entropy
    // data most duels mismatch on byte 0 and the wide loads would cost
    // more than they save (measured 3.7x slower unconditionally)
    while (k >= 16 && k + 32 <= n && ik + 32 <= n && jk + 32 <= n) {
      __m256i a = _mm256_loadu_si256((const __m256i*)(s + ik));
      __m256i b = _mm256_loadu_si256((const __m256i*)(s + jk));
      uint32_t ne =
          ~(uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(a, b));
      if (ne) {
        int32_t adv = (int32_t)__builtin_ctz(ne);
        k += adv;
        ik += adv;
        jk += adv;
        goto compare_one;
      }
      k += 32;
      ik += 32;
      jk += 32;
    }
    if (k >= n) break;
    // a bulk advance can run a cursor exactly to n — wrap before the
    // scalar compare (the original loop recomputed ik/jk mod n each step)
    if (ik >= n) ik -= n;
    if (jk >= n) jk -= n;
#endif
  compare_one:
    int32_t d = (int32_t)s[ik] - (int32_t)s[jk];
    if (d == 0) {
      ++k;
      continue;
    }
    if (d > 0)
      i += k + 1;
    else
      j += k + 1;
    if (i == j) ++j;
    k = 0;
  }
  return i < j ? i : j;
}

}  // namespace

extern "C" int64_t tpubz_bwt(const uint8_t* data, int64_t n64,
                             uint8_t* last, int32_t* key_out) {
  int32_t n = (int32_t)n64;
  *key_out = 0;
  if (n <= 0) return 0;
  if (n == 1) {
    last[0] = data[0];
    return 1;
  }
  int32_t r;
  {
    TPUBZ_PROF(0);
    r = least_rotation(data, n);
  }
  // +8 bytes tail padding: T is the SA-IS value array and the naming
  // loop's word compares overread up to 7 bytes past the last element
  if ((int32_t)tl_T.size() < n + 8) tl_T.resize(n + 8);
  uint8_t* T = tl_T.data();
  std::memcpy(T, data + r, (size_t)(n - r));
  std::memcpy(T + (n - r), data, (size_t)r);
  const int32_t* sa = sais_u8(T, n);

  // smallest period of T dividing n; identical rotations exist iff p < n
  // ("has a period dividing n" is rotation-invariant). Periods dividing n
  // are gcd-closed (Fine–Wilf: two proper ones sum to <= n), so the
  // minimum divides every other and greedy division by n's prime factors
  // reaches it — each candidate is one memcmp that exits on the first
  // mismatch, so the non-periodic common case costs a few bytes per prime
  // (the KMP failure function this replaces built a 4n-byte table).
  // Tie classes are consecutive runs of n/p entries, all congruent mod p
  // in S-space; rewrite each ascending (m, m+p, ...) to match the
  // hostref/device index tie-break.
  auto is_period = [&](int32_t q) {
    return std::memcmp(T, T + q, (size_t)(n - q)) == 0;
  };
  int32_t p = n;
  {
    TPUBZ_PROF(8);
    int32_t rem = n;
    for (int32_t q = 2; (int64_t)q * q <= rem; ++q) {
      while (rem % q == 0) {
        rem /= q;
        if (p % q == 0 && is_period(p / q)) p /= q;
      }
    }
    if (rem > 1 && p % rem == 0 && is_period(p / rem)) p /= rem;
  }

  // BWT last column directly from T (no rot array): S-rotation
  // (sa[i]+r) mod n and T-rotation sa[i] are the same string, so the byte
  // before it is last[i] = T[(sa[i]-1) mod n]. Within a periodic tie
  // class all members are identical rotations, so `last` needs no tie
  // rewrite (T's cyclic period p makes T[(x-1) mod n] constant on the
  // class). key = sorted position of S's rotation 0 = T-rotation
  // (n-r) mod n, folded into the same pass.
  int32_t target = r == 0 ? 0 : n - r;
  int32_t key = 0;
  {
    TPUBZ_PROF(9);
    constexpr int32_t PD = 24;  // sa is sequential; the T[sa[i]-1] read is
                                // random — prefetch it PD entries ahead
    for (int32_t i = 0; i < n; ++i) {
      if (i + PD < n) __builtin_prefetch(&T[sa[i + PD] - 1]);
      int32_t v = sa[i];
      last[i] = T[v == 0 ? n - 1 : v - 1];
      if (v == target) key = i;
    }
  }
  if (p < n) {
    // ascending (m, m+p, ...) tie rewrite puts rotation 0 — class m == 0,
    // smallest member — at the FIRST slot of its n/p-wide class run
    int32_t group = n / p;
    key = key / group * group;
  }
  *key_out = key;
  return n;
}

extern "C" int64_t tpubz_mtf_rle2(const uint8_t* last, int64_t n,
                                  uint16_t* out, uint32_t* freqs,
                                  uint8_t* used) {
  std::memset(freqs, 0, 258 * sizeof(uint32_t));
  std::memset(used, 0, 256);
  for (int64_t i = 0; i < n; ++i) used[last[i]] = 1;
  uint8_t mtf[264];  // 8 spare bytes so the widest 32-lane search load
                     // (offset 232) stays in bounds; lanes past 255 sit
                     // after the guaranteed hit and can never match first
  int32_t na = 0;
  for (int32_t c = 0; c < 256; ++c)
    if (used[c]) mtf[na++] = (uint8_t)c;
  uint16_t eob = (uint16_t)(na + 1);

  int64_t o = 0;
  int64_t zeros = 0;
  auto flush_zeros = [&]() {
    int64_t z = zeros - 1;
    for (;;) {
      uint16_t d = (uint16_t)(z & 1);
      out[o++] = d;
      freqs[d]++;
      if (z < 2) break;
      z = (z - 2) >> 1;
    }
    zeros = 0;
  };
  constexpr uint64_t ONES = 0x0101010101010101ull;
  constexpr uint64_t HIGH = 0x8080808080808080ull;
  int64_t i = 0;
#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
  // Register-resident list head: ranks are MTF-local, so the first 64
  // list entries stay in ONE zmm register across symbols — find is a
  // single cmpeq-mask, the update is a cross-lane vpermb byte shift plus
  // a blend, and NO memory round-trips on the hot path (a masked-store/
  // wide-load version stalled on failed store-forwarding every symbol;
  // measured no better than scalar). Memory bytes 64..255 are only
  // touched on the rare rank>=64 fallback, which syncs the register in
  // and out around a memmove.
  {
    const __m512i shift_idx =
        _mm512_set_epi64(0x3e3d3c3b3a393837ull, 0x363534333231302full,
                         0x2e2d2c2b2a292827ull, 0x262524232221201full,
                         0x1e1d1c1b1a191817ull, 0x161514131211100full,
                         0x0e0d0c0b0a090807ull, 0x0605040302010000ull);
    __m512i zhead = _mm512_loadu_si512(mtf);
    uint8_t head0 = mtf[0];  // scalar mirror of list entry 0
    while (i < n) {
      uint8_t b = last[i];
      if (head0 == b) {
        // zero run: consume the whole run of the current head byte
        int64_t j = i + 1;
        uint64_t pat = (uint64_t)b * ONES;
        while (j + 8 <= n) {
          uint64_t w;
          std::memcpy(&w, last + j, 8);
          uint64_t x = w ^ pat;
          if (x) {
            j += (int64_t)(__builtin_ctzll(x) >> 3);
            goto zrun_end;
          }
          j += 8;
        }
        while (j < n && last[j] == b) ++j;
      zrun_end:
        zeros += j - i;
        i = j;
        continue;
      }
      if (zeros) flush_zeros();
      {
        const __m512i vb = _mm512_set1_epi8((char)b);
        uint64_t m0 = _mm512_cmpeq_epi8_mask(zhead, vb);
        int32_t r;
        if (m0) {
          r = (int32_t)__builtin_ctzll(m0);
          // bytes 0..r take [b, old 0..r-1]; bytes r+1..63 keep their old
          // entries (only the prefix up to the hit rotates)
          __m512i sh = _mm512_mask_mov_epi8(
              _mm512_permutexvar_epi8(shift_idx, zhead), 1, vb);
          zhead = _mm512_mask_mov_epi8(zhead,
                                       _bzhi_u64(~0ull, (uint32_t)r + 1), sh);
        } else {
          _mm512_storeu_si512(mtf, zhead);
          for (int32_t off = 64;; off += 64) {
            uint64_t m = _mm512_cmpeq_epi8_mask(
                _mm512_loadu_si512(mtf + off), vb);
            if (m) {
              r = off + (int32_t)__builtin_ctzll(m);
              break;
            }
          }
          std::memmove(mtf + 1, mtf, (size_t)r);
          mtf[0] = b;
          zhead = _mm512_loadu_si512(mtf);
        }
        head0 = b;
        out[o++] = (uint16_t)(r + 1);
        freqs[r + 1]++;
      }
      ++i;
    }
  }
#else
  // SWAR over the 256-byte MTF list and the input: find-byte and run-scan
  // eight lanes per step with no per-symbol libc call overhead.
  while (i < n) {
    uint8_t b = last[i];
    if (mtf[0] == b) {
      // zero run: consume the whole run of the current head byte at once
      int64_t j = i + 1;
      uint64_t pat = (uint64_t)b * ONES;
      while (j + 8 <= n) {
        uint64_t w;
        std::memcpy(&w, last + j, 8);
        uint64_t x = w ^ pat;
        if (x) {
          j += (int64_t)(__builtin_ctzll(x) >> 3);
          goto run_end;
        }
        j += 8;
      }
      while (j < n && last[j] == b) ++j;
    run_end:
      zeros += j - i;
      i = j;
      continue;
    }
    if (zeros) flush_zeros();
    {
      int32_t r;
      // rank = position in the list: find-byte over the 256-byte list.
      // First 8 entries via one SWAR word (most ranks are tiny — MTF
      // locality), then 32-lane AVX2 sweeps for the high-entropy tail.
      uint64_t w0;
      std::memcpy(&w0, mtf, 8);
      uint64_t x0 = w0 ^ ((uint64_t)b * ONES);
      uint64_t m0 = (x0 - ONES) & ~x0 & HIGH;
      if (m0) {
        r = (int32_t)(__builtin_ctzll(m0) >> 3);
      } else {
#ifdef __AVX2__
        const __m256i vb = _mm256_set1_epi8((char)b);
        for (int32_t off = 8;; off += 32) {
          // the list is 256 bytes; off 8..232 reads stay in bounds via the
          // 264-byte backing array (tail lanes beyond 256 never match
          // before the guaranteed hit)
          __m256i v = _mm256_loadu_si256((const __m256i*)(mtf + off));
          uint32_t mm = (uint32_t)_mm256_movemask_epi8(
              _mm256_cmpeq_epi8(v, vb));
          if (mm) {
            r = off + (int32_t)__builtin_ctz(mm);
            break;
          }
        }
#else
        uint64_t pat = (uint64_t)b * ONES;
        r = 0;
        for (int32_t off = 8;; off += 8) {
          uint64_t w;
          std::memcpy(&w, mtf + off, 8);
          uint64_t x = w ^ pat;
          uint64_t m = (x - ONES) & ~x & HIGH;
          if (m) {
            r = off + (int32_t)(__builtin_ctzll(m) >> 3);
            break;
          }
        }
#endif
      }
      if (r < 8) {
        // in-register shift of the head word: bytes 1..r get old 0..r-1
        uint64_t w;
        std::memcpy(&w, mtf, 8);
        uint64_t repl = (w << 8) | b;
        if (r < 7) {
          uint64_t keep = ~0ull << (8 * (r + 1));
          repl = (repl & ~keep) | (w & keep);
        }
        std::memcpy(mtf, &repl, 8);
      } else {
        std::memmove(mtf + 1, mtf, (size_t)r);
        mtf[0] = b;
      }
      out[o++] = (uint16_t)(r + 1);
      freqs[r + 1]++;
    }
    ++i;
  }
#endif
  if (zeros) flush_zeros();
  out[o++] = eob;
  freqs[eob]++;
  return o;
}

// Fused entry: one GIL-free call per block for the threaded host engine.
extern "C" int64_t tpubz_block_transform(const uint8_t* data, int64_t n,
                                         uint16_t* rle2_out, uint32_t* freqs,
                                         uint8_t* used, int32_t* key_out) {
  thread_local std::vector<uint8_t> tl_last;
  if ((int64_t)tl_last.size() < (n > 0 ? n : 1))
    tl_last.resize(n > 0 ? (size_t)n : 1);
  if (tpubz_bwt(data, n, tl_last.data(), key_out) < 0) return -1;
  return tpubz_mtf_rle2(tl_last.data(), n, rle2_out, freqs, used);
}

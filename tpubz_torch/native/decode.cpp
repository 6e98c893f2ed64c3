// Native block decoder: bit-exact mirror of tpubz/hostref/block.py
// decode_block (reference semantics src/compression/decompress.rs:81-389).
//
// One call decodes one block starting at an arbitrary bit offset (blocks are
// not byte-aligned) and returns the raw bytes, the block CRC from the
// stream, the computed CRC, and the end bit position. Thread-safe and
// GIL-free, so the Python layer runs blocks in parallel across a thread
// pool (the pbzip2 strategy the reference explicitly does not implement,
// src/compression/decompress.rs:3-4).
#include <cstdint>
#include <cstring>
#include <vector>
#include <memory>
#include <algorithm>
#include <chrono>

namespace {

constexpr int kMaxLenDecode = 20;
constexpr int kGroupSize = 50;
constexpr int64_t kZeroBomb = 2 * 1024 * 1024;

struct BitReader {
  const uint8_t* d;
  int64_t nbits;
  int64_t pos;
  bool ok = true;

  uint64_t read(int n) {
    if (pos + n > nbits) {
      ok = false;
      return 0;
    }
    uint64_t out = 0;
    int64_t p = pos;
    pos += n;
    // byte-spanning MSB-first read
    int64_t first = p >> 3;
    int64_t last = (p + n - 1) >> 3;
    uint64_t acc = 0;
    for (int64_t i = first; i <= last; i++) acc = (acc << 8) | d[i];
    int drop = (int)((last - first + 1) * 8 - (p & 7) - n);
    out = (acc >> drop) & ((n == 64) ? ~0ull : ((1ull << n) - 1));
    return out;
  }
  int bit() { return (int)read(1); }
};

// bzip2 CRC32 (MSB-first, poly 0x04C11DB7) with slice-by-8 tables:
// processing 8 bytes per iteration breaks the 1-byte dependent-lookup chain
// (~3 ns/byte) into 8 independent lookups (~1 ns/byte).
struct CrcTable {
  uint32_t t[8][256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i << 24;
      for (int k = 0; k < 8; k++)
        c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : (c << 1);
      t[0][i] = c;
    }
    for (int s = 1; s < 8; s++)
      for (uint32_t i = 0; i < 256; i++)
        t[s][i] = (t[s - 1][i] << 8) ^ t[0][t[s - 1][i] >> 24];
  }
};
const CrcTable kCrc;

// CRC over a buffer, slice-by-8, with bzip2's pre/post inversion.
uint32_t crc32_buf(const uint8_t* p, int64_t n) {
  uint32_t crc = 0xFFFFFFFFu;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    crc = kCrc.t[7][p[i] ^ (crc >> 24)] ^
          kCrc.t[6][p[i + 1] ^ ((crc >> 16) & 0xFF)] ^
          kCrc.t[5][p[i + 2] ^ ((crc >> 8) & 0xFF)] ^
          kCrc.t[4][p[i + 3] ^ (crc & 0xFF)] ^
          kCrc.t[3][p[i + 4]] ^ kCrc.t[2][p[i + 5]] ^
          kCrc.t[1][p[i + 6]] ^ kCrc.t[0][p[i + 7]];
  }
  for (; i < n; i++)
    crc = (crc << 8) ^ kCrc.t[0][((crc >> 24) ^ p[i]) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

constexpr int kLutBits = 12;

struct DecodeTable {
  int min_len, max_len;
  int32_t base[kMaxLenDecode + 2];
  int32_t limit[kMaxLenDecode + 2];
  int32_t off[kMaxLenDecode + 2];
  int32_t syms[258];
  // direct lookup for codes <= kLutBits: (sym << 5) | len, or -1
  int16_t lut[1 << kLutBits];
  // pair lookup: when two whole codes fit in the kLutBits window, one load
  // resolves both (avg code ~5 bits on compressible data, so most windows
  // hold a pair): sym1 | sym2<<9 | total_bits<<18 | has2<<24, or -1 when
  // even the first code does not resolve within the window
  int32_t lut2[1 << kLutBits];
};

// Returns false when the code lengths oversubscribe the canonical code
// space (sum of 2^-len > 1): such a stream is corrupt, and proceeding
// would make limit[l] exceed (1<<l)-1 and overflow the LUT fill below.
bool build_decode_table(const int32_t* lens, int alpha, DecodeTable* t) {
  int min_len = 32, max_len = 0;
  for (int s = 0; s < alpha; s++) {
    min_len = std::min(min_len, (int)lens[s]);
    max_len = std::max(max_len, (int)lens[s]);
  }
  t->min_len = min_len;
  t->max_len = max_len;
  // canonical order: ascending (len, sym)
  int pos = 0;
  int prev_limit = -1;
  for (int l = min_len; l <= max_len; l++) {
    int cnt = 0;
    for (int s = 0; s < alpha; s++)
      if (lens[s] == l) t->syms[pos + cnt++] = s;
    if (l == min_len)
      t->base[l] = 0;
    else
      t->base[l] = (prev_limit + 1) << 1;
    if (t->base[l] + cnt > (1 << l)) return false;  // oversubscribed code
    t->off[l] = pos;
    t->limit[l] = t->base[l] + cnt - 1;  // cnt==0 -> base-1 (never matches)
    prev_limit = t->limit[l];
    pos += cnt;
  }
  // direct-lookup fill for codes resolving within kLutBits
  std::memset(t->lut, 0xFF, sizeof(t->lut));
  for (int l = min_len; l <= std::min(max_len, kLutBits); l++) {
    int cnt = t->limit[l] - t->base[l] + 1;
    for (int c = 0; c < cnt; c++) {
      int sym = t->syms[t->off[l] + c];
      int32_t code = t->base[l] + c;
      int span = 1 << (kLutBits - l);
      int32_t start = code << (kLutBits - l);
      for (int k = 0; k < span; k++)
        t->lut[start + k] = (int16_t)((sym << 5) | l);
    }
  }
  for (int w = 0; w < (1 << kLutBits); w++) {
    const int16_t h1 = t->lut[w];
    if (h1 < 0) {
      t->lut2[w] = -1;
      continue;
    }
    const int s1 = h1 >> 5, l1 = h1 & 31;
    const int16_t h2 = t->lut[(w << l1) & ((1 << kLutBits) - 1)];
    // second code counts only if it resolves entirely within the window's
    // remaining real bits (the shifted-in zeros below must stay unused)
    if (l1 < kLutBits && h2 >= 0 && (h2 & 31) <= kLutBits - l1) {
      const int s2 = h2 >> 5, l2 = h2 & 31;
      t->lut2[w] = s1 | (s2 << 9) | ((l1 + l2) << 18) | (1 << 24);
    } else {
      t->lut2[w] = s1 | (511 << 9) | (l1 << 18);
    }
  }
  return true;
}

}  // namespace

// Decodes one block. Returns: >0 = number of raw bytes written, and sets
// *end_bit / *stream_crc_out / *computed_crc_out.
// Negative return codes:
//  -1 bitstream exhausted      -2 invalid key pointer
//  -3 invalid table count      -4 selector out of range
//  -5 invalid code length      -6 invalid Huffman code
//  -7 RLE2 output overflow     -8 zero-run bomb
//  -9 output buffer too small  -10 ran out of selectors
// phases (when non-null): [0] header+tables, [1] Huffman payload+MTF undo,
// [2] ibwt counting sort, [3] chase+RLE1+CRC — seconds.
extern "C" int64_t tpubz_decode_block_prof(
    const uint8_t* data, int64_t nbits, int64_t start_bit, int32_t level,
    uint8_t* out, int64_t out_cap, int64_t* end_bit, uint32_t* block_crc_out,
    uint32_t* computed_crc_out, double* phases) {
  using Clock = std::chrono::steady_clock;
  auto tick = Clock::now();
  auto mark = [&](int i) {
    if (phases) {
      auto now = Clock::now();
      phases[i] += std::chrono::duration<double>(now - tick).count();
      tick = now;
    }
  };
  BitReader br{data, nbits, start_bit};
  uint32_t blk_crc = (uint32_t)br.read(32);
  br.bit();  // randomized flag: read and ignored
  int64_t key = (int64_t)br.read(24);
  if (!br.ok) return -1;
  if (key > (int64_t)level * 100000 + 10) return -2;
  // symbol map
  uint32_t l1 = (uint32_t)br.read(16);
  uint8_t symbol_set[256];
  int nsyms = 0;
  for (int g = 0; g < 16; g++) {
    if (l1 & (0x8000u >> g)) {
      uint32_t w = (uint32_t)br.read(16);
      for (int b = 0; b < 16; b++)
        if (w & (0x8000u >> b)) symbol_set[nsyms++] = (uint8_t)((g << 4) | b);
    }
  }
  if (!br.ok) return -1;
  int alpha = nsyms + 2;
  int eob = nsyms + 1;
  int table_count = (int)br.read(3);
  if (table_count < 2 || table_count > 6) return -3;
  int64_t nsel = (int64_t)br.read(15);
  int64_t max_sel = (int64_t)level * 100000 / kGroupSize;
  std::vector<int32_t> raw_sel;
  raw_sel.reserve(std::min(nsel, max_sel));
  for (int64_t i = 0; i < nsel; i++) {
    int g = 0;
    while (br.bit()) {
      g++;
      if (!br.ok || g > 6) return br.ok ? -4 : -1;
    }
    if ((int64_t)raw_sel.size() < max_sel) raw_sel.push_back(g);
  }
  if (!br.ok) return -1;
  // selector MTF undo
  std::vector<int32_t> selectors(raw_sel.size());
  {
    int idx[6] = {0, 1, 2, 3, 4, 5};
    for (size_t i = 0; i < raw_sel.size(); i++) {
      int g = raw_sel[i];
      if (g >= table_count) return -4;
      int v = idx[g];
      selectors[i] = v;
      for (int m = g; m > 0; m--) idx[m] = idx[m - 1];
      idx[0] = v;
    }
  }
  // code lengths
  std::vector<DecodeTable> tables(table_count);
  for (int t = 0; t < table_count; t++) {
    int32_t lens[258];
    int cur = (int)br.read(5);
    for (int s = 0; s < alpha; s++) {
      while (br.bit()) {
        if (br.bit())
          cur--;
        else
          cur++;
        if (!br.ok) return -1;
      }
      if (cur < 1 || cur > kMaxLenDecode) return -5;
      lens[s] = cur;
    }
    if (!build_decode_table(lens, alpha, &tables[t])) return -5;
  }
  if (!br.ok) return -1;
  mark(0);
  // payload: canonical Huffman decode until EOB, fused with RLE2+MTF undo.
  // One <=20-bit peek per symbol (byte-aligned 64-bit window load), then
  // per-level shift/compare — no bit-by-bit reads.
  int64_t max_size = (int64_t)level * 100000;
  std::vector<uint8_t> mtf_out((size_t)max_size);
  uint8_t mtf[256];
  std::memcpy(mtf, symbol_set, nsyms);
  const int64_t nbytes_total = (nbits + 7) >> 3;
  // 64-bit buffered peek: one unaligned big-endian load per symbol instead
  // of a byte loop (the reference reads bit-by-bit, decompress.rs:293-358)
  auto peek = [&](int64_t bitpos, int n) -> int64_t {
    int64_t idx = bitpos >> 3;
    uint64_t acc;
    if (idx + 8 <= nbytes_total) {
      std::memcpy(&acc, data + idx, 8);
      acc = __builtin_bswap64(acc);
    } else {
      acc = 0;
      for (int k = 0; k < 8; k++) {
        acc <<= 8;
        if (idx + k < nbytes_total) acc |= data[idx + k];
      }
    }
    return (int64_t)((acc >> (64 - (bitpos & 7) - n)) & ((1ll << n) - 1));
  };
  // pass 1 — symbol decode only (tight loop: one unaligned big-endian load
  // per symbol makes a 52-bit MSB-aligned window, LUT hit resolves sym+len
  // in two shifts; no MTF work interleaved so branches stay predictable).
  // A symbol count > max_size+1 can only come from a stream whose output
  // would overflow anyway -> -7, matching the fused loop's eventual error.
  std::unique_ptr<uint16_t[]> symbuf(new uint16_t[(size_t)max_size + 2]);
  int64_t scount = 0;
  bool done = false;
  // standing bit window: one load + bswap feeds 2-4 symbols (codes <= 20
  // bits, refill keeps >= 21 valid top bits) instead of reloading per
  // symbol; bits past the block's end are the next block's — consuming
  // them is prevented by the per-symbol lpos+l bound exactly as before
  int64_t lpos = br.pos;
  uint64_t window = 0;
  int have = 0;
  for (int64_t group = 0; !done; group++) {
    if (group >= (int64_t)selectors.size()) return -10;
    const DecodeTable& T = tables[selectors[group]];
    const int maxl = T.max_len;
    const int16_t* lut = T.lut;
    for (int g = 0; g < kGroupSize; g++) {
      if (have < 21) {
        int64_t idx = lpos >> 3;
        if (idx + 8 <= nbytes_total) {
          uint64_t acc;
          std::memcpy(&acc, data + idx, 8);
          window = __builtin_bswap64(acc) << (lpos & 7);
          have = 64 - (int)(lpos & 7);
        } else {
          if (lpos + T.min_len > nbits) return -1;
          window = (uint64_t)peek(lpos, 56) << 8;  // guarded stream tail
          have = 56;
        }
      }
      // pair fast path: one lut2 load resolves two whole codes when both
      // fit the window (and neither is the EOB, the group has room, and
      // the bounds/output-capacity checks pass — else fall through to the
      // single-symbol path, which re-derives everything independently)
      {
        const int32_t h = T.lut2[window >> (64 - kLutBits)];
        if (h >= 0 && (h >> 24) && g + 1 < kGroupSize) {
          const int s1 = h & 511;
          const int s2 = (h >> 9) & 511;
          const int bits = (h >> 18) & 63;
          if (s1 != eob && lpos + bits <= nbits && scount + 1 <= max_size) {
            lpos += bits;
            window <<= bits;
            have -= bits;
            symbuf[scount++] = (uint16_t)s1;
            if (s2 == eob) {
              done = true;
              break;
            }
            symbuf[scount++] = (uint16_t)s2;
            g++;
            continue;
          }
        }
      }
      int sym, l;
      int16_t hit = lut[window >> (64 - kLutBits)];
      if (hit >= 0) {
        sym = hit >> 5;
        l = hit & 31;
      } else {
        // lut miss => true code longer than kLutBits; for corrupt/incomplete
        // codes max_len may still be <= kLutBits — reject before shifting
        if (maxl <= kLutBits) return -6;
        int64_t cw = (int64_t)(window >> (64 - maxl));
        l = kLutBits + 1 <= T.min_len ? T.min_len : kLutBits + 1;
        int64_t code = cw >> (maxl - l);
        while (code > T.limit[l]) {
          if (l >= maxl) return -6;
          l++;
          code = cw >> (maxl - l);
        }
        sym = T.syms[T.off[l] + code - T.base[l]];
      }
      if (lpos + l > nbits) return -1;
      lpos += l;
      window <<= l;
      have -= l;
      if (sym == eob) {
        done = true;
        break;
      }
      if (scount > max_size) return -7;
      symbuf[scount++] = (uint16_t)sym;
    }
  }
  br.pos = lpos;
  // pass 2 — RLE2 + MTF undo over the symbol buffer. Ranks < 8 use a
  // branchless u64 rotate-insert on the front of the MTF list instead of a
  // memmove call (most symbols of compressible data live there).
  int64_t pos = 0;
  int64_t zeros = 0;
  int64_t bit_mult = 1;
  // byte histogram folded into this pass (literals count as written, runs
  // bulk-add) so the inverse-BWT bucket setup below skips its own full
  // read pass over mtf_out
  int64_t counts[256] = {0};
  for (int64_t i = 0; i < scount; i++) {
    int sym = symbuf[i];
    if (sym <= 1) {  // RUNA / RUNB
      zeros += bit_mult << sym;
      bit_mult <<= 1;
      if (zeros > kZeroBomb) return -8;
      continue;
    }
    if (zeros) {
      if (pos + zeros > max_size) return -7;
      std::memset(&mtf_out[pos], mtf[0], zeros);
      counts[mtf[0]] += zeros;
      pos += zeros;
      zeros = 0;
      bit_mult = 1;
    }
    int r = sym - 1;
    uint8_t b;
    if (r < 8) {
      uint64_t v;
      std::memcpy(&v, mtf, 8);
      b = (uint8_t)(v >> (8 * r));
      uint64_t low = r == 0 ? 0 : (v & ((1ull << (8 * r)) - 1));
      uint64_t keep = r == 7 ? 0 : (v & ~((1ull << (8 * (r + 1))) - 1));
      v = (low << 8) | b | keep;
      std::memcpy(mtf, &v, 8);
    } else {
      b = mtf[r];
      std::memmove(&mtf[1], &mtf[0], r);
      mtf[0] = b;
    }
    if (pos >= max_size) return -7;
    counts[b]++;
    mtf_out[pos++] = b;
  }
  if (zeros) {  // zero run pending at EOB
    if (pos + zeros > max_size) return -7;
    std::memset(&mtf_out[pos], mtf[0], zeros);
    counts[mtf[0]] += zeros;
    pos += zeros;
  }
  mark(1);
  *end_bit = br.pos;
  *block_crc_out = blk_crc;
  int64_t n = pos;
  if (key >= n && n > 0) return -2;
  // inverse BWT: counting-sort next pointers + chase. The byte rides in the
  // top 8 bits of the pointer word (reference packs byte<<24|next the same
  // way, src/bwt_algorithms/bwt_sort.rs:110-115) so each chase step costs
  // ONE dependent cache-missing load instead of two.
  std::vector<uint32_t> tt((size_t)n);
  {
    // counts[] comes pre-filled from the MTF-undo pass above
    int64_t cum[256];
    int64_t acc = 0;
    for (int v = 0; v < 256; v++) {
      cum[v] = acc;
      acc += counts[v];
    }
    for (int64_t i = 0; i < n; i++)
      tt[cum[mtf_out[i]]++] = (uint32_t)i | ((uint32_t)mtf_out[i] << 24);
  }
  mark(2);
  // ---- inverse-BWT chase + RLE1 undo + CRC ----
  // The serial pointer walk is latency-bound: every step is one dependent
  // cache-missing load (~50 ns on this host). But the walk j -> tt[j]&mask
  // visits every index exactly once (single cycle for a valid stream), so
  // the index values that are multiples of S partition the cycle into ~n/S
  // segments, and 16 interleaved cursors can walk mark->next-mark segments
  // concurrently — memory-level parallelism buys ~16x the serial step rate
  // (measured 2.8 vs 45 ns/step). RLE1+CRC then run serially over the
  // segment buffers in discovered successor order. Any irregularity
  // (segment overflow, or a corrupt stream whose pointer graph is not one
  // cycle) falls back to the fused serial walk.
  int64_t out_n = 0;
  int run = 0;
  uint8_t prev_byte = 0;
  bool expect_count = false;
  bool rle_err = false;
  // one byte through the RLE1 state machine (the always-correct slow path)
  auto rle_step = [&](uint8_t b) {
    if (expect_count) {
      if (out_n + b > out_cap) {
        rle_err = true;
        return;
      }
      std::memset(&out[out_n], prev_byte, b);
      out_n += b;
      expect_count = false;
      run = 0;
      return;
    }
    if (out_n >= out_cap) {
      rle_err = true;
      return;
    }
    out[out_n++] = b;
    if (run > 0 && b == prev_byte)
      run++;
    else {
      run = 1;
      prev_byte = b;
    }
    if (run == 4) expect_count = true;
  };
  auto rle_feed = [&](const uint8_t* buf, int64_t len) {
    int64_t i = 0;
    while (i < len) {
      // drain carried state byte-wise: a pending count byte, or an open
      // run that may complete across the buffer boundary. After this,
      // either the buffer is done or run == 1 with the run anchored at
      // buf[i-1] — every later 4-run lies fully in this buffer.
      while (i < len && (expect_count || (run > 0 && buf[i] == prev_byte))) {
        rle_step(buf[i++]);
        if (rle_err) return;
      }
      if (i >= len) return;
      if (run > 0) {  // differing byte: fresh anchor
        rle_step(buf[i++]);
        if (rle_err) return;
      } else if (run == 0) {  // fresh after a count byte
        rle_step(buf[i++]);
        if (rle_err) return;
        continue;  // re-check: the new byte may extend nothing (run==1 now)
      }
      // bulk gap scan: run == 1 anchored at buf[i-1]. A 4-run ending at q
      // (spanning q-3..q) forces buf[q] == buf[q-2], and one ending at q+1
      // forces buf[q+1] == buf[q-1] which implies buf[q] == buf[q-2] too,
      // so stepping q by 2 while buf[q] != buf[q-2] skips both safely
      // (the reference encoder's 2-apart trick, rle1.rs:164-185).
      int64_t q = i + 2;  // earliest in-buffer 4-run end given the anchor
      while (q < len && buf[q] != buf[q - 2]) q += 2;
      // candidate zone at q: find the actual first 4-run end in [q-1, q+1]
      int64_t stop = len;  // exclusive end of the memcpy-safe gap
      int64_t run_end = -1;
      for (int64_t e = q - 1; e <= q + 1 && e < len; e++) {
        if (e >= i + 2 && buf[e] == buf[e - 1] && buf[e] == buf[e - 2] &&
            buf[e] == buf[e - 3]) {
          run_end = e;
          break;
        }
      }
      if (run_end >= 0)
        stop = run_end + 1;  // copy through the run's 4th byte
      else if (q + 2 <= len)
        stop = q;  // no run here: safe through q-1 (scan resumes at q)
      // copy the gap [i, stop) wholesale; no 4-run completes inside it
      // except possibly at stop-1 (handled by the state fix-up below)
      if (out_n + (stop - i) > out_cap) {
        rle_err = true;
        return;
      }
      std::memcpy(&out[out_n], &buf[i], (size_t)(stop - i));
      out_n += stop - i;
      // reconstruct the state machine's (run, prev, expect_count) at stop:
      // count the trailing equal bytes (anchor at i-1 counts for runs
      // touching the gap head)
      prev_byte = buf[stop - 1];
      int r = 1;
      while (r < 4 && stop - 1 - r >= i - 1 && buf[stop - 1 - r] == prev_byte)
        r++;
      run = r;
      expect_count = (run_end >= 0);  // == (run hit 4 at stop-1)
      i = stop;
    }
  };

  constexpr int kLogS = 14;
  constexpr int64_t kS = 1ll << kLogS;
  constexpr int kWays = 16;
  constexpr int64_t kSegCap = kS * 8;
  bool done_par = false;
  if (n >= 4 * kS) {
    int nmark = (int)((n + kS - 1) >> kLogS);
    const bool key_extra = (key & (kS - 1)) != 0;
    const int nseg = nmark + (key_extra ? 1 : 0);
    auto slot_of = [&](uint32_t j) -> int {
      if (key_extra && j == (uint32_t)key) return 0;
      return (int)(j >> kLogS) + (key_extra ? 1 : 0);
    };
    auto start_of = [&](int t) -> uint32_t {
      if (key_extra)
        return t == 0 ? (uint32_t)key : (uint32_t)((int64_t)(t - 1) << kLogS);
      return (uint32_t)((int64_t)t << kLogS);
    };
    // new[] (not vector): value-initializing ~7MB would cost ~1-2 ms/block
    std::unique_ptr<uint8_t[]> segbuf(new uint8_t[(size_t)nseg * kSegCap]);
    std::vector<int64_t> seg_len(nseg, -1);
    std::vector<uint32_t> seg_succ(nseg);
    struct Cur {
      uint32_t j;
      int seg;
      uint8_t* o;
      uint8_t* end;
    };
    Cur cur[kWays];
    int next_seg = 0;
    int alive = 0;
    auto claim = [&](int c) -> bool {
      if (next_seg >= nseg) return false;
      int t = next_seg++;
      cur[c].j = start_of(t);
      cur[c].seg = t;
      cur[c].o = segbuf.get() + (size_t)t * kSegCap;
      cur[c].end = cur[c].o + kSegCap;
      return true;
    };
    for (int c = 0; c < kWays; c++) {
      if (claim(c))
        alive++;
      else
        cur[c].seg = -1;
    }
    bool overflow = false;
    while (alive > 0 && !overflow) {
      for (int c = 0; c < kWays; c++) {
        if (cur[c].seg < 0) continue;
        uint32_t w = tt[cur[c].j];  // tt entries' low 24 bits are < n by
        *cur[c].o++ = (uint8_t)(w >> 24);  // construction: in-bounds always
        uint32_t j = w & 0xFFFFFF;
        cur[c].j = j;
        if (((j & (uint32_t)(kS - 1)) == 0) | (j == (uint32_t)key)) {
          int t = cur[c].seg;
          seg_len[t] = cur[c].o - (segbuf.get() + (size_t)t * kSegCap);
          seg_succ[t] = j;
          if (!claim(c)) {
            cur[c].seg = -1;
            alive--;
          }
        } else if (cur[c].o == cur[c].end) {
          overflow = true;
          break;
        }
      }
    }
    if (!overflow) {
      int64_t total = 0;
      for (int t = 0; t < nseg; t++) total += seg_len[t] < 0 ? 0 : seg_len[t];
      if (total == n) {
        // stitch: feed segments through RLE1+CRC in cycle order from the
        // key's segment; a revisit or missing segment means the pointer
        // graph was not one cycle (corrupt stream) -> serial fallback
        int t = slot_of((uint32_t)key);
        int visited = 0;
        bool bad = false;
        while (visited < nseg) {
          if (t < 0 || t >= nseg || seg_len[t] < 0) {
            bad = true;
            break;
          }
          rle_feed(segbuf.get() + (size_t)t * kSegCap, seg_len[t]);
          if (rle_err) return -9;  // output overflow: identical in serial
          uint32_t succ = seg_succ[t];
          seg_len[t] = -2;  // revisit guard
          visited++;
          t = slot_of(succ);
        }
        done_par = !bad;
      }
    }
  }
  if (!done_par) {
    // fused serial walk: small blocks, and the fallback for any stream the
    // segmented walk could not partition cleanly
    out_n = 0;
    run = 0;
    prev_byte = 0;
    expect_count = false;
    rle_err = false;
    uint32_t p = n ? tt[key] : 0;
    for (int64_t i = 0; i < n; i++) {
      uint32_t e = tt[p & 0xFFFFFF];
      uint8_t b = (uint8_t)(p >> 24);
      p = e;
      rle_feed(&b, 1);
      if (rle_err) return -9;
    }
  }
  // CRC in one slice-by-8 pass over the final output (the fused per-byte
  // chain would serialize the RLE1 feed at ~3 ns/byte)
  *computed_crc_out = crc32_buf(out, out_n);
  mark(3);
  return out_n;
}

extern "C" int64_t tpubz_decode_block(
    const uint8_t* data, int64_t nbits, int64_t start_bit, int32_t level,
    uint8_t* out, int64_t out_cap, int64_t* end_bit, uint32_t* block_crc_out,
    uint32_t* computed_crc_out) {
  return tpubz_decode_block_prof(data, nbits, start_bit, level, out, out_cap,
                                 end_bit, block_crc_out, computed_crc_out,
                                 nullptr);
}

// Stream CRC fold helper (order-dependent; reference src/tools/crc.rs:25-27).
extern "C" uint32_t tpubz_stream_crc_fold(uint32_t s, uint32_t blk) {
  return (((s << 1) | (s >> 31)) ^ blk);
}

// Scan for a 48-bit magic at every bit offset. Writes up to cap offsets;
// returns the number found (clamped to cap).
extern "C" int64_t tpubz_find_magic(const uint8_t* data, int64_t nbytes,
                                    uint64_t magic, int64_t* out,
                                    int64_t cap) {
  if (nbytes < 6) return 0;
  int64_t found = 0;
  const uint64_t mask = (1ull << 48) - 1;
  const uint64_t mask56 = (1ull << 56) - 1;

  // LUT fast path on the fully-interior byte at p+2 (see
  // tpubz_find_magic2 for the derivation)
  uint8_t lut[256];
  std::memset(lut, 0, sizeof(lut));
  for (int s = 0; s < 8; ++s)
    lut[(magic >> (24 + s)) & 0xFF] |= (uint8_t)(1u << s);
  int64_t fast_p_end = nbytes - 8;
  for (int64_t p = 0; p <= fast_p_end; ++p) {
    uint8_t hits = lut[data[p + 2]];
    while (hits) {
      int s = __builtin_ctz(hits);
      hits &= (uint8_t)(hits - 1);
      uint64_t W;
      std::memcpy(&W, data + p, 8);
      W = __builtin_bswap64(W);
      if (((W << s) >> 16 & mask) == magic) {
        if (found < cap) out[found] = 8 * p + s;
        found++;
      }
    }
  }

  // rolling 7-byte window w7 = bytes [p, p+7) MSB-first (56 bits) for the
  // last ≤2 positions (and all of a tiny input)
  int64_t p0 = fast_p_end + 1;
  if (p0 < 0) p0 = 0;
  uint64_t w7 = 0;
  for (int i = 0; i < 6; i++) w7 = (w7 << 8) | data[p0 + i];
  w7 <<= 8;  // placeholder for byte p+6, filled in the loop
  for (int64_t p = p0; p + 6 <= nbytes; p++) {
    int smax;
    if (p + 7 <= nbytes) {
      w7 = (w7 & ~0xFFull) | data[p + 6];
      smax = 8;
    } else {
      w7 &= ~0xFFull;
      smax = 1;
    }
    for (int s = 0; s < smax; s++) {
      if (((w7 >> (8 - s)) & mask) == magic) {
        if (found < cap) out[found] = 8 * p + s;
        found++;
      }
    }
    w7 = (w7 << 8) & mask56;
  }
  return found < cap ? found : cap;
}

// Fused two-magic scan: one pass over the sliding 56-bit window finds both
// the block magic and the footer magic (the decompressor needs both; two
// separate scans cost twice the memory pass).
extern "C" void tpubz_find_magic2(const uint8_t* data, int64_t nbytes,
                                  uint64_t magic1, uint64_t magic2,
                                  int64_t* out1, int64_t cap1, int64_t* n1_out,
                                  int64_t* out2, int64_t cap2,
                                  int64_t* n2_out) {
  *n1_out = 0;
  *n2_out = 0;
  if (nbytes < 6) return;
  int64_t f1 = 0, f2 = 0;
  const uint64_t mask = (1ull << 48) - 1;
  const uint64_t mask56 = (1ull << 56) - 1;

  // Fast path: the byte at p+2 sits fully inside the 48-bit window for
  // every shift s in 0..7 (window bits [16-s, 24-s)), so a 256-entry LUT
  // keyed on that byte yields the candidate (magic, s) slots and only
  // ~16/256 of positions take the verify load — one LUT byte per input
  // byte instead of eight window compares.
  uint16_t lut[256];
  std::memset(lut, 0, sizeof(lut));
  uint8_t slot_s[16];
  for (int which = 0; which < 2; ++which) {
    uint64_t m = which ? magic2 : magic1;
    for (int s = 0; s < 8; ++s) {
      int b = (int)((m >> (24 + s)) & 0xFF);
      int sl = which * 8 + s;
      slot_s[sl] = (uint8_t)s;
      lut[b] |= (uint16_t)(1u << sl);
    }
  }
  int64_t fast_p_end = nbytes - 8;  // verify reads 8 bytes at p
  for (int64_t p = 0; p <= fast_p_end; ++p) {
    uint16_t hits = lut[data[p + 2]];
    while (hits) {
      int sl = __builtin_ctz(hits);
      hits &= (uint16_t)(hits - 1);
      int s = slot_s[sl];
      uint64_t W;
      std::memcpy(&W, data + p, 8);
      W = __builtin_bswap64(W);
      uint64_t v = ((W << s) >> 16) & mask;
      if (sl < 8) {
        if (v == magic1) {
          if (f1 < cap1) out1[f1] = 8 * p + s;
          f1++;
        }
      } else {
        if (v == magic2) {
          if (f2 < cap2) out2[f2] = 8 * p + s;
          f2++;
        }
      }
    }
  }

  // scalar rolling-window tail for the last ≤2 positions (and all of a
  // tiny input), where the 8-byte verify load would run past the buffer
  int64_t p0 = fast_p_end + 1;
  if (p0 < 0) p0 = 0;
  uint64_t w7 = 0;
  for (int i = 0; i < 6; i++) w7 = (w7 << 8) | data[p0 + i];
  w7 <<= 8;
  for (int64_t p = p0; p + 6 <= nbytes; p++) {
    int smax;
    if (p + 7 <= nbytes) {
      w7 = (w7 & ~0xFFull) | data[p + 6];
      smax = 8;
    } else {
      w7 &= ~0xFFull;
      smax = 1;
    }
    for (int s = 0; s < smax; s++) {
      uint64_t v = (w7 >> (8 - s)) & mask;
      if (v == magic1) {
        if (f1 < cap1) out1[f1] = 8 * p + s;
        f1++;
      } else if (v == magic2) {
        if (f2 < cap2) out2[f2] = 8 * p + s;
        f2++;
      }
    }
    w7 = (w7 << 8) & mask56;
  }
  *n1_out = f1;
  *n2_out = f2;
}

// Standalone block CRC export (CRC-32/BZIP2, slice-by-8): the encode path's
// per-block CRC over the raw pre-RLE1 bytes (reference src/tools/crc.rs:
// 15-22) — the numpy bit-reversal+zlib route pays two extra passes over
// the block (measured 2.8 ms vs <1 native on a 900k block).
extern "C" uint32_t tpubz_block_crc(const uint8_t* data, int64_t n) {
  return crc32_buf(data, n);
}

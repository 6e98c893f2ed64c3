// Whole-block emission — native engine, one call per block.
//
// Everything after the transform: Huffman refinement (refine.cpp), then
// the block's packed bits — 48-bit magic + CRC + randomized bit + key
// (reference compress_block.rs:34-48), two-level symbol map
// (rle2_mtf.rs:293-322), table/selector counts, MTF'd unary selectors,
// per-table 5-bit origin + delta code lengths, canonical codes ascending
// by (length, symbol) (huffman.rs:207-466), and the payload. Byte-for-
// byte identical to the Python emit path (block/emit.py + hostref/
// huffman.py), which stays as the no-toolchain fallback and fuzz oracle.
//
// Why: per-block emission was the last GIL-holding leg of the CPU
// engine's hot path (~2.6 ms/block of numpy/python across 12 workers
// serializes on the interpreter); this makes a worker's whole block one
// GIL-free native call after the transform.
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" int64_t tpubz_refine_stream(const uint16_t*, int64_t, int32_t,
                                       int32_t, int32_t*, int32_t*,
                                       int32_t*);

namespace {

// MSB-first bit writer (semantics of hostref/bitio.py BitAccum.pack:
// final-byte pad bits zeroed).
struct BitW {
  uint8_t* out;
  int64_t cap;
  uint64_t acc = 0;
  int fill = 0;
  int64_t nbytes = 0;
  int64_t bits = 0;
  bool ovf = false;
  void put(uint64_t v, int b) {  // b <= 48 (fill < 8 on entry => <= 56)
    if (b <= 0) return;
    acc = (acc << b) | (v & ((b >= 64) ? ~0ull : ((1ull << b) - 1)));
    fill += b;
    bits += b;
    while (fill >= 8) {
      fill -= 8;
      if (nbytes >= cap) {
        ovf = true;
        fill = 0;
        return;
      }
      out[nbytes++] = (uint8_t)(acc >> fill);
    }
  }
  void finish() {
    if (fill > 0) {
      if (nbytes >= cap) {
        ovf = true;
        return;
      }
      out[nbytes++] = (uint8_t)(acc << (8 - fill));
      fill = 0;
    }
  }
};

}  // namespace

// Returns packed byte count (total bit length via *total_bits), or -1 on
// insufficient out_cap. syms = the full RLE2 stream INCLUDING the EOB.
extern "C" int64_t tpubz_emit_block(int32_t key, uint32_t crc,
                                    const uint16_t* syms, int64_t rle2_len,
                                    const uint8_t* used /*[256] 0/1*/,
                                    int32_t iters, uint8_t* out,
                                    int64_t out_cap, int64_t* total_bits) {
  int32_t alpha = 2;
  for (int c = 0; c < 256; ++c) alpha += used[c] ? 1 : 0;
  const int64_t nsel = (rle2_len + 49) / 50;
  std::vector<int32_t> sel((size_t)std::max<int64_t>(nsel, 1));
  std::vector<int32_t> lens((size_t)6 * alpha);
  int32_t table_count = 0;
  tpubz_refine_stream(syms, rle2_len, alpha, iters, sel.data(), lens.data(),
                      &table_count);

  BitW bw{out, out_cap};
  // header: magic as two 24-bit halves (compress_block.rs:34-41)
  bw.put(0x314159ull, 24);
  bw.put(0x265359ull, 24);
  bw.put(crc, 32);
  bw.put(0, 1);  // randomized: always 0
  bw.put((uint32_t)key, 24);
  // two-level symbol map
  uint32_t l1 = 0;
  uint32_t l2[16] = {0};
  for (int c = 0; c < 256; ++c)
    if (used[c]) {
      l1 |= 0x8000u >> (c >> 4);
      l2[c >> 4] |= 0x8000u >> (c & 15);
    }
  bw.put(l1, 16);
  for (int g = 0; g < 16; ++g)
    if (l2[g]) bw.put(l2[g], 16);
  bw.put((uint32_t)table_count, 3);
  bw.put((uint64_t)nsel, 15);
  // selectors: MTF + unary (huffman.rs:237-292)
  {
    int idx[6] = {0, 1, 2, 3, 4, 5};
    for (int64_t i = 0; i < nsel; ++i) {
      int v = sel[i];
      int r = 0;
      while (idx[r] != v) r++;
      bw.put(((1ull << r) - 1) << 1, r + 1);
      for (int m = r; m > 0; --m) idx[m] = idx[m - 1];
      idx[0] = v;
    }
  }
  // per-table delta-coded lengths + canonical codes (codes ascending by
  // (length, symbol), huffman.rs:340-438)
  std::vector<uint32_t> codes((size_t)table_count * alpha);
  for (int t = 0; t < table_count; ++t) {
    const int32_t* L = lens.data() + (size_t)t * alpha;
    int cur = L[0];
    bw.put((uint32_t)cur, 5);
    for (int s = 0; s < alpha; ++s) {
      int d = L[s] - cur;
      cur = L[s];
      for (; d > 0; --d) bw.put(0b10, 2);
      for (; d < 0; ++d) bw.put(0b11, 2);
      bw.put(0, 1);
    }
    uint32_t* C = codes.data() + (size_t)t * alpha;
    uint32_t code = 0;
    int prev_len = -1;
    for (int l = 1; l <= 20; ++l)
      for (int s = 0; s < alpha; ++s)
        if (L[s] == l) {
          if (prev_len < 0)
            prev_len = l;
          else if (l != prev_len) {
            code <<= (l - prev_len);
            prev_len = l;
          }
          C[s] = code++;
        }
  }
  // payload: per-symbol (code, len) by the 50-chunk selector
  for (int64_t i = 0; i < rle2_len;) {
    const int64_t end = std::min<int64_t>(i + 50, rle2_len);
    const int32_t t = sel[i / 50];
    const uint32_t* C = codes.data() + (size_t)t * alpha;
    const int32_t* L = lens.data() + (size_t)t * alpha;
    for (; i < end; ++i) {
      const uint16_t s = syms[i];
      bw.put(C[s], L[s]);
    }
  }
  bw.finish();
  if (bw.ovf) return -1;
  *total_bits = bw.bits;
  return bw.nbytes;
}

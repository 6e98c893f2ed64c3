// MSB-first bit packer — native engine.
//
// Sequential 64-bit-queue packer (semantics of the reference
// src/bitstream/bitpacker.rs:17-111 and of tpubz/hostref/bitio.py:pack_bits,
// which tests cross-check byte-for-byte). The numpy scatter formulation
// bottoms out in ufunc.at at ~1M fields/s; this runs at memory speed.
#include <cstdint>

extern "C" int64_t tpubz_pack_bits(const uint32_t* vals, const int64_t* bits,
                                   int64_t n, uint8_t* out,
                                   int64_t cap_bytes, int64_t* total_bits) {
  uint64_t acc = 0;
  int nacc = 0;
  int64_t nbytes = 0;
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) {
    const int b = (int)bits[i];
    if (b == 0) continue;
    acc = (acc << b) | (vals[i] & ((b >= 32) ? 0xFFFFFFFFu : ((1u << b) - 1)));
    nacc += b;
    total += b;
    while (nacc >= 8) {
      if (nbytes >= cap_bytes) return -1;
      out[nbytes++] = (uint8_t)(acc >> (nacc - 8));
      nacc -= 8;
    }
  }
  if (nacc > 0) {
    if (nbytes >= cap_bytes) return -1;
    out[nbytes++] = (uint8_t)(acc << (8 - nacc));
  }
  *total_bits = total;
  return nbytes;
}

// One-pass Huffman payload emitter: per-symbol (code, length) lookup by the
// 50-symbol chunk's selector, packed MSB-first into uint32 words (final
// partial word left-aligned, matching BitAccum.put_words). Replaces the
// numpy repeat + double fancy-gather + pack path (~14 ms/block at 900k ->
// ~2 ms). Reference behavior: huffman.rs:452-466 + bitpacker.rs:17-111.
extern "C" int64_t tpubz_emit_payload(const uint16_t* syms, int64_t n,
                                      const int32_t* sel,
                                      const uint32_t* codes,  // [6*258]
                                      const int32_t* lens,    // [6*258]
                                      uint32_t* out_words,
                                      int64_t cap_words) {
  uint64_t acc = 0;
  int fill = 0;
  int64_t w = 0;
  int64_t total = 0;
  for (int64_t i = 0; i < n;) {
    const int64_t end = (i + 50 < n) ? i + 50 : n;
    const int32_t t = sel[i / 50];
    const uint32_t* ct = codes + (int64_t)t * 258;
    const int32_t* lt = lens + (int64_t)t * 258;
    for (; i < end; ++i) {
      const uint16_t s = syms[i];
      const int b = lt[s];  // <= 20, so fill stays < 52 before draining
      acc = (acc << b) | ct[s];
      fill += b;
      total += b;
      while (fill >= 32) {
        fill -= 32;
        if (w >= cap_words) return -1;
        out_words[w++] = (uint32_t)(acc >> fill);
      }
    }
  }
  if (fill > 0) {
    if (w >= cap_words) return -1;
    out_words[w++] = (uint32_t)(acc << (32 - fill));
  }
  return total;
}

// RLE1 pre-pass + block splitting — native engine.
//
// Exact mirror of tpubz/hostref/rle1.py (rle1_encode + split_blocks):
// runs of 4..255 identical bytes -> 4 literals + count byte (run-4); longer
// runs re-scan greedily in 255-byte segments (reference src/tools/rle1.rs
// semantics). Block cut points replicate C bzip2's ADD_CHAR_TO_BLOCK state
// machine exactly (the `nblock >= nblockMAX` check runs BEFORE each input
// byte and pending-run flushes can overshoot): a block closes at the end of
// the first RLE1 segment that brings its output size >= budget — so blocks
// end at >= budget (up to budget+4), not <= budget — provided at least two
// input bytes follow the boundary (otherwise the EOF flush joins the final
// pending run to the current block). Matching C's cuts keeps per-block
// content identical to C bzip2's, which pins the <=-C-size guarantee on
// multi-block inputs. Each block's raw input range is reported for the
// pre-RLE1 CRC.
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {
constexpr int kRunThreshold = 4;
constexpr int kMaxRun = 255;

// true iff a run of >= 4 equal bytes starts at p (single u32 compare)
inline bool run4_at(const uint8_t* in, int64_t p) {
  uint32_t w;
  std::memcpy(&w, in + p, 4);
  return w == (uint32_t)in[p] * 0x01010101u;
}
}

// out cap must be >= n + n/255 + 16 (5 out per 255-run segment; literals
// dominate). blocks: rows of (out_lo, out_hi, in_lo, in_hi), cap rows >=
// out_len/budget + 2. Returns number of blocks; *out_len_p = total RLE1
// output length.
extern "C" int64_t tpubz_rle1_split(const uint8_t* in, int64_t n,
                                    int64_t budget, uint8_t* out,
                                    int64_t* out_len_p, int64_t* blocks,
                                    int64_t blocks_cap) {
  int64_t out_len = 0;
  int64_t nblocks = 0;
  int64_t blk_out_lo = 0, blk_in_lo = 0;
  int64_t i = 0;

  auto close_block = [&](int64_t in_pos) {
    if (nblocks < blocks_cap) {
      blocks[nblocks * 4 + 0] = blk_out_lo;
      blocks[nblocks * 4 + 1] = out_len;
      blocks[nblocks * 4 + 2] = blk_in_lo;
      blocks[nblocks * 4 + 3] = in_pos;
    }
    nblocks++;
    blk_out_lo = out_len;
    blk_in_lo = in_pos;
  };

  // cut after the segment that just ended at input position i (its flush
  // byte is in[i]; C's budget check fires at in[i+1], so a cut needs i+1
  // to exist as a further input byte: i <= n-2)
  auto maybe_cut = [&]() {
    if (out_len - blk_out_lo >= budget && i <= n - 2) close_block(i);
  };

  while (i < n) {
    if (i + 3 < n && run4_at(in, i)) {
      // run of >= 4: greedy segments of up to kMaxRun
      const uint8_t b = in[i];
      int64_t j = i + 4;
      while (j < n && in[j] == b) j++;
      int64_t run = j - i;
      while (run > 0) {
        int64_t seg = std::min<int64_t>(run, kMaxRun);
        if (seg >= kRunThreshold) {
          std::memset(out + out_len, b, kRunThreshold);
          out[out_len + kRunThreshold] = (uint8_t)(seg - kRunThreshold);
          out_len += kRunThreshold + 1;
        } else {
          std::memset(out + out_len, b, seg);
          out_len += seg;
        }
        run -= seg;
        i += seg;
        maybe_cut();
      }
    } else {
      // literal stretch: scan to the next >=4 run start; bulk-copy until
      // the budget crossing, then extend the cut to the end of the short
      // (<4) same-byte run containing it — C flushes short runs whole, so
      // cut points never split one.
      int64_t j = i + 1;
      while (j + 3 < n && !run4_at(in, j)) j++;
      if (j + 3 >= n) j = n;  // tail is all literals
      while (i < j) {
        int64_t remaining = budget - (out_len - blk_out_lo);
        int64_t take;
        if (remaining > j - i) {
          take = j - i;  // whole stretch fits without reaching the budget
        } else {
          int64_t cut = i + std::max<int64_t>(remaining, 1);
          while (cut < j && in[cut] == in[cut - 1]) cut++;
          take = cut - i;
        }
        std::memcpy(out + out_len, in + i, take);
        out_len += take;
        i += take;
        maybe_cut();
      }
    }
  }
  if (out_len > blk_out_lo || nblocks == 0) {
    if (n > 0) {
      if (nblocks < blocks_cap) {
        blocks[nblocks * 4 + 0] = blk_out_lo;
        blocks[nblocks * 4 + 1] = out_len;
        blocks[nblocks * 4 + 2] = blk_in_lo;
        blocks[nblocks * 4 + 3] = n;
      }
      nblocks++;
    }
  }
  *out_len_p = out_len;
  return nblocks;
}

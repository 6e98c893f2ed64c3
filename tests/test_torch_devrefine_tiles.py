"""The decompositions of the device refine kernels (csrc/huffman_dev.cu,
csrc/bitpack.cu), emulated in numpy on the CPU with the kernels' index math,
against tpubz's chunk_hist, refine_pass, pack_bits_device and pack_payload.

The CUDA kernels run only on the card. Here each is run CTA by CTA, warp by
warp and thread by thread as its source writes it: chunk_hist_rows' warp a
group with the row's lanes; refine_rows' grid-stride loop over the groups,
each lane's nine bins, the strict-< scan, the CTA's frequencies in shared
memory added to the global ones; pack_tiles' tiles taken by ticket, the
threads' consecutive fields, the block scan and the look-back as a running
offset, and each thread's register that gathers the fields of one word
before its atomicOr (with a field that opens the next word), in 32-bit
arithmetic. Tiles and grids are small, so fields and words cross threads
and tiles. Every comparison is exact: tolerance 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tpubz.kernels import huffman_dev as thd
from tpubz.kernels.bitpack import pack_bits_device as t_pack_bits

GROUP, ALPHA, TABLES, WARP = 50, 258, 6, 32
MASK = 0xFFFFFFFF
OUT = 1508  # 31 groups, the last 8 lanes short


def _syms(seed, out=OUT):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, ALPHA, out)
    s[rng.random(out) < 0.5] = rng.integers(0, 2)
    return s.astype(np.uint16)


def chunk_hist_rows(syms, lengths, warps):
    """csrc/huffman_dev.cu:chunk_hist_rows over a grid of (ceil(nsel / warps), B)."""
    B, out = syms.shape
    nsel = -(-out // GROUP)
    hist = np.full((B, nsel, ALPHA), -1, np.int64)  # every row is stored
    for row in range(B):
        for cta in range(-(-nsel // warps)):
            for warp in range(warps):
                g = cta * warps + warp
                if g >= nsel:
                    continue
                h = np.zeros(ALPHA, np.int64)
                for lane in range(WARP):
                    for k in range(lane, GROUP, WARP):
                        i = g * GROUP + k
                        if i < out and i < lengths[row] and syms[row, i] < ALPHA:
                            h[syms[row, i]] += 1
                hist[row, g] = h
    return hist


@pytest.mark.parametrize("warps", [1, 8])
def test_chunk_hist_rows_matches_tpubz(warps):
    lengths = np.array([1, 49, 50, 51, 777, OUT], np.int32)
    s = np.stack([_syms(b) for b in range(lengths.size)])
    want = np.asarray(thd.chunk_hist_batch(jnp.asarray(s), jnp.asarray(lengths)))
    assert np.array_equal(chunk_hist_rows(s, lengths, warps), want)


def refine_rows(hist, lens, tc, ctas, warps):
    """csrc/huffman_dev.cu:refine_rows on a grid of ``ctas`` CTAs of
    ``warps`` warps (the call caps the grid at 264)."""
    nsel = hist.shape[0]
    sel = np.full(nsel, -1, np.int64)
    rfreq = np.zeros((TABLES, ALPHA), np.int64)
    stride = ctas * warps
    for cta in range(ctas):
        s_rfreq = np.zeros((TABLES, ALPHA), np.int64)
        for warp in range(warps):
            for g in range(cta * warps + warp, nsel, stride):
                # lane l holds bins l, l + 32, ..., its partial costs reduced
                # across the warp
                partial = np.zeros((WARP, TABLES), np.int64)
                for lane in range(WARP):
                    for j in range(-(-ALPHA // WARP)):
                        s = lane + WARP * j
                        if s < ALPHA:
                            partial[lane] += hist[g, s] * lens[:, s]
                cost = partial.sum(0)
                best = 0
                for t in range(1, TABLES):
                    if t < tc and cost[t] < cost[best]:
                        best = t
                sel[g] = best
                s_rfreq[best] += hist[g]
        rfreq += s_rfreq  # the CTA's non-zero sums by atomics
    return sel, rfreq


@pytest.mark.parametrize("ctas,warps", [(1, 1), (3, 2), (264, 16)])
@pytest.mark.parametrize("tc", [2, 4, 6])
def test_refine_rows_matches_tpubz(tc, ctas, warps):
    rng = np.random.default_rng(10 * tc + ctas)
    hist = np.asarray(thd.chunk_hist(jnp.asarray(_syms(tc)), jnp.int32(1200)))
    lens = rng.integers(1, 18, (TABLES, ALPHA)).astype(np.int32)
    lens[tc:] = 0  # past the count, cheapest, never chosen
    if tc > 2:
        lens[2] = lens[1]  # a tie: table 1 wins it
    ts, tr = thd.refine_pass(jnp.asarray(hist), jnp.asarray(lens), jnp.int32(tc))
    sel, rfreq = refine_rows(hist, lens, tc, min(ctas, -(-hist.shape[0] // warps)), warps)
    assert np.array_equal(sel, np.asarray(ts)) and np.array_equal(rfreq, np.asarray(tr))


def pack_tiles(fields, m, out_words, threads, per):
    """csrc/bitpack.cu:pack_tiles with tiles of threads x per fields.
    ``fields(i)`` -> (value, bits) of lane i < m. Returns (words, total)."""
    words = [0] * out_words
    tile = threads * per
    before = 0  # the look-back's result: the bits of the tiles before

    def or_word(w, bits):
        if bits and w < out_words:
            words[w] |= bits

    for t in range(-(-m // tile)):  # tickets in order
        loaded = [[fields(i) if i < m else (0, 0)
                   for i in range(t * tile + th * per, t * tile + th * per + per)]
                  for th in range(threads)]
        sums = [sum(b for _, b in f) for f in loaded]
        offs = np.concatenate(([0], np.cumsum(sums)[:-1]))  # the block scan
        for th in range(threads):
            pos, cur, acc = before + int(offs[th]), -1, 0
            for v, b in loaded[th]:
                if b == 0:
                    continue
                w, end = pos >> 5, (pos & 31) + b
                if w != cur:
                    or_word(cur, acc)
                    cur, acc = w, 0
                if end <= 32:
                    acc |= (v << (32 - end)) & MASK
                else:
                    or_word(w, acc | (v >> (end - 32)))
                    cur, acc = w + 1, (v << (64 - end)) & MASK
                pos += b
            or_word(cur, acc)
        before += sum(sums)
    return np.array(words, np.uint32), before


def _fields(seed, m):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 25, m).astype(np.int32)
    bits[::5] = 0
    bits[2::9] = 24
    vals = (rng.integers(0, 1 << 24, m) & ((1 << bits) - 1)).astype(np.uint32)
    vals[bits == 24] = (1 << 24) - 1
    return vals, bits


@pytest.mark.parametrize("threads,per", [(1, 1), (4, 3), (8, 16)])
@pytest.mark.parametrize("spare", [1, -20])
def test_pack_tiles_matches_tpubz(threads, per, spare):
    """Fields across threads and tiles; with too few words the fields past
    them are dropped."""
    vals, bits = _fields(threads * per, 700)
    out_words = (int(bits.sum()) + 31) // 32 + spare
    tw, tt = t_pack_bits(jnp.asarray(vals), jnp.asarray(bits), out_words)
    words, total = pack_tiles(lambda i: (int(vals[i]), int(bits[i])), vals.size, out_words,
                              threads, per)
    assert np.array_equal(words, np.asarray(tw)) and total == int(tt)


@pytest.mark.parametrize("rle2_len", [1, 51, 1234])
def test_pack_tiles_payload_form_matches_tpubz(rle2_len):
    """The payload form: each lane below rle2_len gathers its code and length
    through sel[i / 50]; the lanes past it are fields of 0 bits."""
    rng = np.random.default_rng(rle2_len)
    s = _syms(rle2_len + 1)
    lens = rng.integers(1, 18, (TABLES, ALPHA)).astype(np.int32)
    codes = (rng.integers(0, 1 << 17, (TABLES, ALPHA)) & ((1 << lens) - 1)).astype(np.uint32)
    sel = rng.integers(0, TABLES, -(-OUT // GROUP)).astype(np.int8)
    tw, tt = thd.pack_payload(jnp.asarray(s), jnp.int32(rle2_len), jnp.asarray(sel),
                              jnp.asarray(codes), jnp.asarray(lens))

    def fields(i):
        if i >= rle2_len:
            return 0, 0
        t, sym = int(sel[i // GROUP]), int(s[i])
        return int(codes[t, sym]), int(lens[t, sym])

    words, total = pack_tiles(fields, OUT, thd.payload_words_cap(OUT), 8, 16)
    assert np.array_equal(words, np.asarray(tw)) and total == int(tt)

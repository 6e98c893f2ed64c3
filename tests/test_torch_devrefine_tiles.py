"""The decompositions of the device refine kernels (csrc/huffman_dev.cu,
csrc/bitpack.cu), emulated in numpy on the CPU with the kernels' index math,
against tpubz's chunk_hist, refine_pass (over its chunk_hist), pack_bits_device
and pack_payload.

The CUDA kernels run only on the card. Here each is run CTA by CTA, warp by
warp and thread by thread as its source writes it: chunk_hist_rows' warp a
group with the row's lanes; refine_symbols' grid-stride loop over warp
tiles of 16 groups (consecutive tiles to consecutive CTAs; a tile past the
stream only writes its selectors 0) staged with the symbols past the
stream as 258, each
lane's 25 symbols' six lengths unpacked from their bytes and summed,
the pair's shuffle, the strict-<
scan, one count a symbol in the CTA's frequencies, the CTAs' sums added to
the scratch in a random order and moved out by the last CTA's ticket, which
leaves the scratch zero for the next pass; pack_tiles as
tests/torch_pack_emulation.py runs it (tiles by ticket that zero their
slices of the words, the threads' consecutive fields, the block scan, the
look-back on a fresh scratch, and the words built from each tile's first
bit, one OR a field's word, then stored whole or ORed where two tiles
share them), in 32-bit arithmetic. Tiles and
grids are small, so fields and words cross threads and tiles. Every
comparison is exact: tolerance 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tpubz.kernels import huffman_dev as thd
from tpubz.kernels.bitpack import pack_bits_device as t_pack_bits

from torch_pack_emulation import Scratch, emulate_pack

GROUP, ALPHA, TABLES, WARP = 50, 258, 6, 32
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


WARP_GROUPS = 16  # groups a warp takes at once, two lanes a group
LANE_SYMS = GROUP // 2
SUMS = TABLES * ALPHA


def refine_symbols(syms, rle2_len, lens, tc, ctas, warps, scratch, rng):
    """csrc/huffman_dev.cu:refine_symbols over a grid of at most ``ctas``
    CTAs of ``warps`` warps (the call caps the grid at 132 and gives each
    CTA 16 warps), the CTAs in ``rng``'s order. ``scratch``: the int64
    words the CTAs add their sums into (1,548, then the ticket), zero before
    and left zero. Returns (sel, rfreq)."""
    out = syms.size
    nsel = -(-out // GROUP)
    tiles = -(-nsel // WARP_GROUPS)
    grid = min(-(-tiles // warps), ctas)
    # the shared lengths: two words a symbol, a byte a table; symbol 258 (a
    # lane past the stream) has none; tables past tc none
    pk = np.zeros((ALPHA + 1, 2), np.int64)
    for t in range(tc):
        pk[:ALPHA, t >> 2] |= (lens[t].astype(np.int64) & 0xFF) << (8 * (t & 3))
    length = min(rle2_len, out)
    sel = np.full(nsel, -1, np.int64)
    rfreq = np.full((TABLES, ALPHA), -1, np.int64)
    for cta in rng.permutation(grid):
        s_rfreq = np.zeros(SUMS, np.int64)
        for warp in range(warps):
            for tile in range(warp * grid + cta, tiles, grid * warps):
                base = tile * WARP_GROUPS * GROUP
                if base >= length:  # past the stream: no symbol, table 0
                    g = tile * WARP_GROUPS + np.arange(WARP_GROUPS)
                    sel[g[g < nsel]] = 0
                    continue
                pos = base + np.arange(WARP_GROUPS * GROUP)
                staged = np.full(pos.size, ALPHA, np.int64)
                live = pos < length
                staged[live] = np.minimum(syms[pos[live]], ALPHA)
                mine = staged.reshape(WARP, LANE_SYMS)  # lane l: group l // 2, half l % 2
                words = pk[mine]  # one 8-byte load a symbol
                c = np.stack([((words[:, :, t >> 2] >> (8 * (t & 3))) & 0xFF).sum(1)
                              for t in range(TABLES)], 1)
                c = c + c[np.arange(WARP) ^ 1]  # the pair's shuffle
                for lane in range(WARP):
                    best = 0
                    for t in range(1, TABLES):
                        if t < tc and c[lane, t] < c[lane, best]:
                            best = t
                    g = tile * WARP_GROUPS + lane // 2
                    if lane % 2 == 0 and g < nsel:
                        sel[g] = best
                    for sym in mine[lane]:
                        if sym < ALPHA:
                            s_rfreq[best * ALPHA + sym] += 1
        scratch[:SUMS] += s_rfreq  # the CTA's non-zero sums by atomics
        ticket = scratch[SUMS]
        scratch[SUMS] += 1
        if ticket == grid - 1:  # the last CTA: the sums read and zeroed, the ticket re-armed
            rfreq = scratch[:SUMS].reshape(TABLES, ALPHA).copy()
            scratch[:] = 0
    return sel, rfreq


OUT_R = WARP_GROUPS * GROUP * 7 + 13  # 113 groups, 8 warp tiles, the last one short


@pytest.mark.parametrize("ctas,warps", [(1, 1), (3, 2), (132, 1), (132, 16)])
@pytest.mark.parametrize("tc", [2, 4, 6])
def test_refine_symbols_matches_tpubz(tc, ctas, warps):
    """Two passes on one scratch (as a block's passes run), each equal to
    tpubz's refine_pass over its chunk_hist, the scratch zero after each."""
    rng = np.random.default_rng(10 * tc + ctas + warps)
    s = _syms(tc, OUT_R)
    scratch = np.zeros(SUMS + 1, np.int64)
    hist = thd.chunk_hist(jnp.asarray(s), jnp.int32(OUT_R - 40))
    for _ in range(2):
        lens = rng.integers(1, 18, (TABLES, ALPHA)).astype(np.int32)
        lens[tc:] = 0  # past the count, cheapest, never chosen
        if tc > 2:
            lens[2] = lens[1]  # a tie: table 1 wins it
        ts, tr = thd.refine_pass(hist, jnp.asarray(lens), jnp.int32(tc))
        sel, rfreq = refine_symbols(s, OUT_R - 40, lens, tc, ctas, warps, scratch, rng)
        assert np.array_equal(sel, np.asarray(ts)) and np.array_equal(rfreq, np.asarray(tr))
        assert not scratch.any()


@pytest.mark.parametrize("rle2_len", [1, 49, 50, 51, 777, OUT_R])
def test_refine_symbols_stream_lengths(rle2_len):
    """A group's edges and the last warp tile's partial group: lanes past
    the stream stage symbol 258, which costs nothing and counts nowhere."""
    rng = np.random.default_rng(rle2_len)
    s = _syms(rle2_len, OUT_R)
    lens = rng.integers(1, 18, (TABLES, ALPHA)).astype(np.int32)
    scratch = np.zeros(SUMS + 1, np.int64)
    ts, tr = thd.refine_pass(thd.chunk_hist(jnp.asarray(s), jnp.int32(rle2_len)),
                             jnp.asarray(lens), jnp.int32(6))
    sel, rfreq = refine_symbols(s, rle2_len, lens, 6, 3, 2, scratch, rng)
    assert np.array_equal(sel, np.asarray(ts)) and np.array_equal(rfreq, np.asarray(tr))


def pack_tiles(fields, m, out_words, threads, per, length=None):
    """csrc/bitpack.cu:pack_tiles with tiles of threads x per fields, the
    arrays on 16-byte boundaries (tests/torch_pack_emulation.py).
    ``fields(i)`` -> (value, bits) of lane i < m, or of the stream's
    ``length`` lanes (the payload form). Returns (words, total)."""
    words, total, _ = emulate_pack(fields, m, out_words, threads=threads, per=per,
                                   vec=4 if per % 4 == 0 else 1, length=length,
                                   scratch=Scratch(-(-(m + 7) // (threads * per))), window=4,
                                   seed=threads * per)
    return words, total


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
        t, sym = int(sel[i // GROUP]), int(s[i])
        return int(codes[t, sym]), int(lens[t, sym])

    words, total = pack_tiles(fields, OUT, thd.payload_words_cap(OUT), 8, 16, length=rle2_len)
    assert np.array_equal(words, np.asarray(tw)) and total == int(tt)

"""The packing kernel and the compact form's kernel without a memset
(csrc/bitpack.cu, csrc/compact.cu on csrc/look_back.cuh), emulated in numpy
on the CPU with the kernels' index math (tests/torch_pack_emulation.py),
against tpubz's pack_bits_device, pack_payload and _stage_compact on the
JAX CPU backend.

Tiles are small (2 to 8 threads of 4 to 16 lanes) and look-back windows
narrow (2 to 32 lanes), so that fields, words and the look-back cross
tiles and windows; the tiles' second parts run in order, in reverse and at
random among the first parts. Every comparison is exact: tolerance 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpubz.block.encode import _stage_compact
from tpubz.kernels import huffman_dev as thd
from tpubz.kernels.bitpack import pack_bits_device as t_pack_bits

from torch_pack_emulation import (EPOCH_MAX, EPOCH_SHIFT, Scratch, emulate_compact,
                                  emulate_pack, status_word)

GROUP, ALPHA, TABLES = 50, 258, 6


def _fields(seed, m, zero_from=None, zero_to=None):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 25, m).astype(np.int32)
    bits[::5] = 0
    bits[2::9] = 24
    if zero_from is not None:
        bits[zero_from:zero_to] = 0
    vals = (rng.integers(0, 1 << 24, m) & ((1 << bits) - 1)).astype(np.uint32)
    vals[bits == 24] = (1 << 24) - 1
    return vals, bits


def _tpubz_words(vals, bits, out_words):
    tw, tt = t_pack_bits(jnp.asarray(vals), jnp.asarray(bits), out_words)
    return np.asarray(tw), int(tt)


def _array(vals, bits):
    return lambda i: (int(vals[i]), int(bits[i]))


# (threads, per, vec): vec the lanes of a 16-byte vector (4 int32, 8 uint16)
SHAPES = [(2, 4, 4), (4, 8, 4), (8, 16, 4)]


@pytest.mark.parametrize("threads,per,vec", SHAPES, ids=["t8", "t32", "t128"])
@pytest.mark.parametrize("shift,bits_shift", [(0, 0), (1, 1), (3, 2)],
                         ids=["aligned", "both+1", "vals+3_bits+2"])
@pytest.mark.parametrize("spare", ["few", "one", "past_every_slice"])
def test_pack_tiles_emulation_matches_tpubz(threads, per, vec, shift, bits_shift, spare):
    """The array form, the values and the lengths at their own alignments,
    into fewer words than the stream (fields dropped), one more word, and
    more words than every tile's lanes reach (tiles that only zero)."""
    m = 700
    vals, bits = _fields(threads * per + shift, m)
    need = (int(bits.sum()) + 31) // 32
    out_words = {"few": need // 3, "one": need + 1,
                 "past_every_slice": (-(-(m + shift) // (threads * per)) + 2) * threads * per}[spare]
    words, total, info = emulate_pack(_array(vals, bits), m, out_words, threads=threads, per=per,
                                      vec=vec, shift=shift, bits_shift=bits_shift,
                                      scratch=Scratch(512), window=4, seed=shift)
    tw, tt = _tpubz_words(vals, bits, out_words)
    assert np.array_equal(words, tw) and total == tt
    if spare == "past_every_slice":
        assert info["ctas"] > info["stream_tiles"]
    # only the threads at the array's ends load lane by lane (and the
    # lengths, where they do not share the values' alignment)
    ends = 2 if shift else 1
    assert info["lane_loads"] - (info["vector_loads"] if (shift - bits_shift) % vec else 0) <= ends


@pytest.mark.parametrize("m", [1, 15, 31, 32, 33, 97])
def test_pack_tiles_edge_shapes(m):
    """One field, a partial tile, a tile, a tile and one; a tile of only
    0-bit fields between two others."""
    vals, bits = _fields(m, m, zero_from=32, zero_to=64)
    out_words = (int(bits.sum()) + 31) // 32 + 2
    words, total, _ = emulate_pack(_array(vals, bits), m, out_words, threads=4, per=8, vec=4,
                                   shift=m % 4, bits_shift=0, scratch=Scratch(8), window=2)
    tw, tt = _tpubz_words(vals, bits, out_words)
    assert np.array_equal(words, tw) and total == tt


def _payload(seed, out):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, ALPHA, out)
    s[rng.random(out) < 0.5] = rng.integers(0, 2)
    lens = rng.integers(1, 18, (TABLES, ALPHA)).astype(np.int32)
    codes = (rng.integers(0, 1 << 17, (TABLES, ALPHA)) & ((1 << lens) - 1)).astype(np.uint32)
    sel = rng.integers(0, TABLES, -(-out // GROUP)).astype(np.int8)
    return s, sel, codes, lens


@pytest.mark.parametrize("rle2_len", [0, 1, 31, 32, 33, 500, 1508])
@pytest.mark.parametrize("vec,shift", [(4, 0), (4, 3), (8, 0), (8, 5)],
                         ids=["i32", "i32+3", "u16", "u16+5"])
def test_pack_payload_emulation_matches_tpubz(rle2_len, vec, shift):
    """The payload form: the stream's lanes gather their codes through
    sel[i / 50]; only the tiles that hold a lane of the stream load the
    tables, scan and look back; the tile of the stream's last lane writes
    the total (tile 0 for an empty stream)."""
    out = 1508
    s, sel, codes, lens = _payload(rle2_len + shift, out)
    tw, tt = thd.pack_payload(jnp.asarray(s.astype(np.uint16)), jnp.int32(rle2_len),
                              jnp.asarray(sel), jnp.asarray(codes), jnp.asarray(lens))

    def fields(i):
        t, sym = int(sel[i // GROUP]), int(s[i])
        return int(codes[t, sym]), int(lens[t, sym])

    cap = thd.payload_words_cap(out)
    words, total, info = emulate_pack(fields, out, cap, threads=4, per=8, vec=vec, shift=shift,
                                      length=rle2_len, scratch=Scratch(512), window=4,
                                      seed=rle2_len)
    assert np.array_equal(words, np.asarray(tw)) and total == int(tt)
    stream_tiles = -(-(rle2_len + shift) // 32) if rle2_len else 0
    assert info["tables_loaded"] == info["stream_tiles"] == stream_tiles
    assert info["ctas"] == max(-(-(out + shift) // 32), -(-cap // 32))


@pytest.mark.parametrize("vec,shift", [(8, 0), (8, 3)], ids=["u16", "u16+3"])
@pytest.mark.parametrize("max_bits", [3, 5])
def test_pack_payload_short_codes(vec, shift, max_bits):
    """Codes of 1 to 3 (or 5) bits, as a level-9 payload's mostly are: many
    fields to a word, each ORed into it, words shared by threads and
    tiles: tpubz's words."""
    out = 1508
    s, sel, codes, lens = _payload(max_bits, out)
    lens = np.random.default_rng(max_bits).integers(1, max_bits + 1, lens.shape).astype(np.int32)
    codes = (codes & ((1 << lens) - 1)).astype(np.uint32)
    tw, tt = thd.pack_payload(jnp.asarray(s.astype(np.uint16)), jnp.int32(out), jnp.asarray(sel),
                              jnp.asarray(codes), jnp.asarray(lens))

    def fields(i):
        t, sym = int(sel[i // GROUP]), int(s[i])
        return int(codes[t, sym]), int(lens[t, sym])

    words, total, _ = emulate_pack(fields, out, thd.payload_words_cap(out), threads=4, per=8,
                                   vec=vec, shift=shift, length=out, scratch=Scratch(512),
                                   window=4, seed=max_bits)
    assert np.array_equal(words, np.asarray(tw)) and total == int(tt)


@pytest.mark.parametrize("order", ["in_order", "reverse", "random"])
def test_pack_look_back_in_every_publication_order(order):
    """The tiles' second parts in order (each look-back meets its
    neighbour's inclusive count), in reverse (each reads aggregates back to
    tile 0, window after window) and interleaved at random: tpubz's words
    every time, and no word written before its slice was seen zeroed."""
    m = 2000
    vals, bits = _fields(11, m)
    out_words = (int(bits.sum()) + 31) // 32 + 1
    words, total, info = emulate_pack(_array(vals, bits), m, out_words, threads=2, per=8, vec=4,
                                      shift=1, bits_shift=1, scratch=Scratch(200), window=4,
                                      order=order, seed=3)
    tw, tt = _tpubz_words(vals, bits, out_words)
    assert np.array_equal(words, tw) and total == tt
    steps = [info["read"][t] for t in sorted(info["read"])]
    if order == "in_order":
        assert set(steps) == {1}
    elif order == "reverse":
        assert steps == list(range(1, len(steps) + 1))
    else:
        assert min(steps) == 1 and max(steps) > 1


def _rows(seed, B, out, p_hi=0.2):
    rng = np.random.default_rng(seed)
    lo = 1 - p_hi
    p = [lo * 0.5, lo * 0.3, lo * 0.2, p_hi * 0.6, p_hi * 0.3, p_hi * 0.1]
    return rng.choice([0, 3, 255, 256, 257, 300], size=(B, out), p=p).astype(np.uint16)


def _tpubz_compact(syms, lengths):
    u8, hi, cnt = jax.vmap(_stage_compact)(jnp.asarray(syms), jnp.asarray(lengths, jnp.int32))
    return np.asarray(u8), np.asarray(hi), np.asarray(cnt)


@pytest.mark.parametrize("out", [1, 8, 40, 72, 100])
@pytest.mark.parametrize("sym_offset", [0, 1, 5])
@pytest.mark.parametrize("threads", [2, 4])
def test_compact_emulation_matches_tpubz(out, sym_offset, threads):
    """Rows of 1 to 100 symbols at each row's own alignment (the buffer at
    an odd element offset), stream lengths of 0, 1, half, all, past the row
    and negative: tpubz's bytes, sidecars and counts."""
    lengths = np.array([0, 1, out // 2, out, out + 5, -2], np.int32)
    syms = _rows(out + sym_offset, lengths.size, out)
    u8, hi, cnt, _ = emulate_compact(syms, lengths, threads=threads, sym_offset=sym_offset,
                                     scratch=Scratch(512), window=2, seed=out)
    tu8, thi, tcnt = _tpubz_compact(syms, lengths)
    assert np.array_equal(u8, tu8) and np.array_equal(hi, thi) and np.array_equal(cnt, tcnt)


def test_compact_sidecar_overflow_row():
    """A row with more symbols >= 256 than the sidecar holds: the first
    HI_CAP entries and the full count, beside a row with none."""
    out = 9_000
    syms = _rows(1, 2, out, p_hi=0.99)
    syms[1] = 4
    lengths = np.array([out, out], np.int32)
    u8, hi, cnt, _ = emulate_compact(syms, lengths, threads=8, scratch=Scratch(160), window=32,
                                     seed=2)
    tu8, thi, tcnt = _tpubz_compact(syms, lengths)
    assert cnt[0] > 8192 and cnt[1] == 0
    assert np.array_equal(u8, tu8) and np.array_equal(hi, thi) and np.array_equal(cnt, tcnt)


@pytest.mark.parametrize("sym_offset,widths", [(0, {16, 8}), (8, {16, 8}), (1, None)])
def test_compact_stores_whole_words(sym_offset, widths):
    """Rows of N + 8 symbols, N a multiple of 16 (a level-9 row's shape):
    each row's symbols start on a 16-byte boundary and its bytes 0 or 8
    bytes past one, so every thread that holds 16 symbols of the row loads
    them as two vectors and stores its bytes as one 16-byte or two 8-byte
    words; only the last thread of a row goes lane by lane. A buffer at an
    odd element offset shifts the tiles instead."""
    out = 7 * 16 + 8
    lengths = np.full(5, out, np.int32)
    syms = _rows(4, 5, out)
    u8, hi, cnt, info = emulate_compact(syms, lengths, threads=2, sym_offset=sym_offset,
                                        scratch=Scratch(512), window=4, seed=5)
    tu8, thi, tcnt = _tpubz_compact(syms, lengths)
    assert np.array_equal(u8, tu8) and np.array_equal(hi, thi) and np.array_equal(cnt, tcnt)
    if widths is not None:
        assert set(info["store_widths"]) == widths
        assert info["lane_loads"] == 5  # each row's last thread


@pytest.mark.parametrize("order", ["in_order", "reverse", "random"])
def test_compact_look_back_in_every_publication_order(order):
    """The rows' tiles publish in order, in reverse and at random, one
    ticket counter for all rows: tpubz's outputs every time."""
    out = 600
    lengths = np.array([out, 333, 0], np.int32)
    syms = _rows(9, 3, out)
    u8, hi, cnt, _ = emulate_compact(syms, lengths, threads=2, sym_offset=3, scratch=Scratch(512),
                                     window=4, order=order, seed=9)
    tu8, thi, tcnt = _tpubz_compact(syms, lengths)
    assert np.array_equal(u8, tu8) and np.array_equal(hi, thi) and np.array_equal(cnt, tcnt)


@pytest.mark.parametrize("start_epoch", [0, EPOCH_MAX - 2], ids=["fresh", "across_the_wrap"])
def test_calls_back_to_back_on_one_scratch(start_epoch):
    """Calls of both kernels back to back on one scratch, large, small and
    large again (each meets the words of the one before), starting fresh
    and across the epoch's wrap: each equals tpubz, and after each the
    ticket is 0 and every status word is the call's or 0."""
    sc = Scratch(160, epoch=start_epoch)
    epochs = []
    for k, m in enumerate([2000, 100, 1200, 40, 2000]):
        vals, bits = _fields(k, m)
        out_words = (int(bits.sum()) + 31) // 32 + 1
        words, total, _ = emulate_pack(_array(vals, bits), m, out_words, threads=4, per=8, vec=4,
                                       shift=k % 4, bits_shift=0, scratch=sc, window=4, seed=k)
        epochs.append(sc.epoch)
        tw, tt = _tpubz_words(vals, bits, out_words)
        assert np.array_equal(words, tw) and total == tt, k
        lengths = np.array([m // 3, m], np.int32)
        syms = _rows(k, 2, m)
        got = emulate_compact(syms, lengths, threads=2, sym_offset=k, scratch=sc, window=4,
                              seed=k)[:3]
        epochs.append(sc.epoch)
        assert all(np.array_equal(g, t) for g, t in zip(got, _tpubz_compact(syms, lengths))), k
    if start_epoch:
        assert EPOCH_MAX in epochs and 1 in epochs


def test_a_stale_word_of_the_calls_epoch_would_be_read():
    """Why every call zeroes the words it does not publish: a word of the
    call's own epoch left from an earlier call (as an epoch that came round
    again would find it) is taken for a publication and gives a wrong
    offset; zeroed, it is waited for."""
    from torch_pack_emulation import AGGREGATE, look_back

    status = [status_word(5, AGGREGATE, 999)] + [0] * 3
    assert look_back(status, 1, 5, 4) == (999, [0])  # a stale word, read
    status[0] = 0
    assert look_back(status, 1, 5, 4) is None  # zero: not yet published
    assert status_word(EPOCH_MAX, AGGREGATE, 7) >> EPOCH_SHIFT == EPOCH_MAX


def test_constants_and_probe_edits_follow_the_sources():
    """The Python side's mirrors of csrc/look_back.cuh, csrc/bitpack.cu and
    csrc/compact.cu (the epoch's range, the status stride, the tiles, the
    shift) equal the sources' constants, and every edit of
    tpubz_torch.pack_probe's timeline and variants applies once."""
    import os
    import re

    from tpubz_torch import pack_probe
    from tpubz_torch.kernels import _build, bitpack, compact, look_back

    def const(name, file):
        text = open(os.path.join(_build.CSRC_DIR, file)).read()
        return re.search(rf"constexpr (?:int|unsigned) {name} = ([^;]+);", text).group(1)

    assert const("kEpochMax", "look_back.cuh") == "(1u << 26) - 1"
    assert look_back.EPOCH_MAX == EPOCH_MAX == (1 << 26) - 1
    assert int(const("kEpochShift", "look_back.cuh")) == EPOCH_SHIFT
    assert int(const("kThreads", "bitpack.cu")) * int(const("kPer", "bitpack.cu")) == \
        bitpack.TILE == look_back.TILE
    assert int(const("kThreads", "compact.cu")) * int(const("kPer", "compact.cu")) == compact.TILE
    assert int(const("kShiftMax", "compact.cu")) == look_back.SHIFT_MAX
    assert int(const("kHiCap", "compact.cu")) == compact.HI_CAP
    for file, edits in pack_probe.TIMELINE.items():
        assert "g_marks" in pack_probe._edited(file, edits)
    for edits in pack_probe.VARIANTS.values():
        pack_probe._edited("look_back.cuh", edits)

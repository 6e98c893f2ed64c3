"""The port's device refine kernels and their host pieces against tpubz's on
the CPU, tolerance 0 (the codec is integer).

Seeded numpy inputs go through tpubz's jitted functions on the JAX CPU
backend (``chunk_hist``, ``chunk_hist_batch``, ``refine_pass`` over
``chunk_hist``, ``pack_payload``, ``pack_bits_device``) and through the
port's wrappers (``refine_pass`` over the symbols themselves), which run
their plain versions for CPU tensors; whole arrays are compared,
pad rows and pad words included. Symbol streams hold the symbols 256 and
257 (RUNA/RUNB over rank 255, and the EOB); lengths cover one symbol,
49, 50 and 51 (a group's edges) and lengths that are no multiple of 50.
The host pieces (the initial tables, canonical codes, block headers, the
symbol map, ``BitAccum.put_words``, the Huffman constants) are held to
tpubz's on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubz.format import constants as tconst
from tpubz.format.symbol_map import encode_symbol_map as t_symbol_map
from tpubz.hostref import huffman as thuff
from tpubz.hostref.bitio import BitAccum as TAccum
from tpubz.kernels import huffman_dev as thd
from tpubz.kernels.bitpack import pack_bits_device as t_pack_bits
from tpubz.kernels.bitpack import words_to_bytes as t_words_to_bytes

from tpubz_torch.format import constants as pconst
from tpubz_torch.format.symbol_map import encode_symbol_map
from tpubz_torch.hostref import huffman as phuff
from tpubz_torch.hostref.bitio import BitAccum, pack_bits
from tpubz_torch.kernels import bitpack, huffman_dev

from torch_native_guard import tpubz_native  # noqa: F401 (a fixture)

OUT = 2008  # symbol lanes: 41 groups, the last one 8 lanes short


def _syms(seed, out=OUT):
    """Symbols in [0, 258) with runs of RUNA/RUNB and 256/257 sprinkled in."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 258, out)
    s[rng.random(out) < 0.4] = rng.integers(0, 2)
    s[:: 97] = 256
    s[5:: 131] = 257
    return s.astype(np.uint16)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


@pytest.mark.parametrize("rle2_len", [1, 49, 50, 51, 1234, OUT])
def test_chunk_hist_matches_tpubz(rle2_len):
    """Every row of the histogram, rows past the stream (zero) included, for
    int32 and uint16 symbols and a length given as an int or a 0-d int64."""
    s = _syms(rle2_len)
    want = np.asarray(thd.chunk_hist(jnp.asarray(s), jnp.int32(rle2_len)))
    assert want.shape == (huffman_dev.nsel_cap(OUT), 258)
    for syms in (_t(s, np.int32), _t(s)):
        for length in (rle2_len, torch.tensor(rle2_len)):
            got = huffman_dev.chunk_hist(syms, length)
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_chunk_hist_batch_matches_tpubz():
    """Rows of lengths 1, 49, 50, 51 and 1234 in one call; each row is also
    the one-block histogram of that row."""
    lengths = np.array([1, 49, 50, 51, 1234], np.int32)
    s = np.stack([_syms(10 + b) for b in range(lengths.size)])
    want = np.asarray(thd.chunk_hist_batch(jnp.asarray(s), jnp.asarray(lengths)))
    got = huffman_dev.chunk_hist_batch(_t(s), _t(lengths))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for b, n in enumerate(lengths):
        assert torch.equal(got[b], huffman_dev.chunk_hist(_t(s[b], np.int32), int(n)))


def _refine_both(s, rle2_len, lens, tc):
    """tpubz's pass over its histogram of the symbols, and the port's over
    the symbols, uint16 with a 0-d int64 length and int32 with a host int
    (the two must agree)."""
    hist = thd.chunk_hist(jnp.asarray(s), jnp.int32(rle2_len))
    ts, tr = thd.refine_pass(hist, jnp.asarray(lens), jnp.int32(tc))
    ps, pr = huffman_dev.refine_pass(_t(s), torch.tensor(rle2_len), _t(lens), tc)
    assert ps.dtype == torch.int8 and pr.dtype == torch.int32
    assert ps.shape == (huffman_dev.nsel_cap(s.size),)
    qs, qr = huffman_dev.refine_pass(_t(s, np.int32), rle2_len, _t(lens), tc)
    assert torch.equal(ps, qs) and torch.equal(pr, qr)
    return (np.asarray(ts), np.asarray(tr)), (ps.numpy(), pr.numpy()), np.asarray(hist)


@pytest.mark.parametrize("tc", [2, 3, 4, 5, 6])
def test_refine_pass_matches_tpubz(tc):
    """The whole selector and frequency arrays (the groups past the stream
    select table 0) for each table count; the rows of lens past it hold
    stale 15s and never win."""
    rng = np.random.default_rng(tc)
    lens = rng.integers(1, 18, (6, 258)).astype(np.int32)
    lens[tc:] = 15
    (ts, tr), (ps, pr), hist = _refine_both(_syms(tc), 1500, lens, tc)
    assert np.array_equal(ps, ts) and np.array_equal(pr, tr)
    assert (ps[30:] == 0).all() and ps.max() < tc
    assert np.array_equal(pr.sum(0), hist.sum(0))


def test_refine_pass_ties_go_to_the_lowest_table():
    """Two identical tables: every group that prefers them takes the lower
    one, as tpubz's argmin does; a table past the count that would be
    cheapest is never chosen."""
    rng = np.random.default_rng(7)
    lens = rng.integers(1, 18, (6, 258)).astype(np.int32)
    lens[3] = lens[1]
    lens[5] = 0  # cheapest of all, but past the table count
    (ts, tr), (ps, pr), _ = _refine_both(_syms(7), 1500, lens, 5)
    assert np.array_equal(ps, ts) and np.array_equal(pr, tr)
    assert (ps == 1).any() and not (ps == 3).any() and not (ps == 5).any()


@pytest.mark.parametrize("rle2_len", [1, 49, 50, 51, 777, OUT])
def test_refine_pass_stream_lengths(rle2_len):
    """A group's edges and a partial last group: the symbols past the
    stream add nothing and their groups select 0; rows past the count hold
    zero lengths (cheapest, never chosen)."""
    rng = np.random.default_rng(rle2_len)
    lens = rng.integers(1, 18, (6, 258)).astype(np.int32)
    lens[4:] = 0
    (ts, tr), (ps, pr), hist = _refine_both(_syms(30 + rle2_len), rle2_len, lens, 4)
    assert np.array_equal(ps, ts) and np.array_equal(pr, tr)
    assert (ps[huffman_dev.nsel_cap(rle2_len):] == 0).all() and int(pr.sum()) == rle2_len


def _fields(seed, m):
    """Fields of 0 to 24 bits, each value below 2^bits: zero-length fields,
    full 24-bit fields and fields that cross a word."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, 25, m).astype(np.int32)
    bits[::7] = 0
    bits[3::11] = 24
    vals = (rng.integers(0, 1 << 24, m) & ((1 << bits) - 1)).astype(np.uint32)
    vals[1::13] = (1 << bits[1::13]) - 1  # all ones
    return vals, bits


@pytest.mark.parametrize("seed,m", [(0, 1), (1, 500), (2, 5000)])
def test_pack_bits_matches_tpubz(seed, m):
    """Words (one spare), total and bytes equal tpubz's, and the bytes equal
    the host packer's on the fields of non-zero length."""
    vals, bits = _fields(seed, m)
    total = int(bits.sum())
    cap = (total + 31) // 32 + 1
    tw, tt = t_pack_bits(jnp.asarray(vals), jnp.asarray(bits), cap)
    pw, pt = bitpack.pack_bits_device(_t(vals.view(np.int32)), _t(bits), cap)
    assert pw.dtype == torch.int32 and pt.dtype == torch.int64
    assert np.array_equal(pw.numpy().view(np.uint32), np.asarray(tw))
    assert int(pt) == int(tt) == total
    got = bitpack.words_to_bytes(pw, total)
    assert got == t_words_to_bytes(tw, total)
    live = bits > 0
    assert got == pack_bits(vals[live], bits[live])


def test_pack_bits_drops_fields_past_the_words():
    """Fields past out_words are dropped, as tpubz's scatter drops them; the
    total still counts them."""
    vals, bits = _fields(3, 400)
    tw, tt = t_pack_bits(jnp.asarray(vals), jnp.asarray(bits), 40)
    pw, pt = bitpack.pack_bits_device(_t(vals.view(np.int32)), _t(bits), 40)
    assert np.array_equal(pw.numpy().view(np.uint32), np.asarray(tw)) and int(pt) == int(tt)


def _tables(seed, tc=6):
    """Selectors, codes and lengths of tc random tables (each code below
    2^length)."""
    rng = np.random.default_rng(seed)
    lens = np.zeros((6, 258), np.int32)
    codes = np.zeros((6, 258), np.uint32)
    for t in range(tc):
        lens[t] = rng.integers(1, 18, 258)
        codes[t] = phuff.canonical_codes(lens[t]) & ((1 << lens[t]) - 1)
    sel = rng.integers(0, tc, huffman_dev.nsel_cap(OUT)).astype(np.int8)
    return sel, codes, lens


@pytest.mark.parametrize("rle2_len", [1, 51, 1234, OUT])
def test_pack_payload_matches_tpubz(rle2_len):
    """The payload's words (every one of payload_words_cap) and bit count,
    for int32 and uint16 symbols; lanes past rle2_len add no bits."""
    s = _syms(20 + rle2_len)
    sel, codes, lens = _tables(rle2_len)
    tw, tt = thd.pack_payload(jnp.asarray(s), jnp.int32(rle2_len), jnp.asarray(sel),
                              jnp.asarray(codes), jnp.asarray(lens))
    for syms in (_t(s, np.int32), _t(s)):
        pw, pt = huffman_dev.pack_payload(syms, torch.tensor(rle2_len), _t(sel),
                                          _t(codes.view(np.int32)), _t(lens))
        assert pw.shape == (huffman_dev.payload_words_cap(OUT),)
        assert np.array_equal(pw.numpy().view(np.uint32), np.asarray(tw)) and int(pt) == int(tt)


@pytest.mark.parametrize("tc", [2, 3, 4, 5, 6])
def test_c_init_tables_matches_tpubz(tc):
    rng = np.random.default_rng(100 + tc)
    for alpha in (3, 40, 258):
        freqs = rng.integers(0, 500, 258).astype(np.int64)
        freqs[rng.random(258) < 0.3] = 0
        want = thuff.c_init_tables(freqs, tc, alpha)
        got = phuff.c_init_tables(freqs, tc, alpha)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_canonical_codes_matches_tpubz():
    rng = np.random.default_rng(5)
    for alpha in (2, 3, 100, 258):
        lens = rng.integers(1, 18, alpha)
        assert np.array_equal(phuff.canonical_codes(lens), thuff.canonical_codes(lens))


@pytest.mark.parametrize("tc", [2, 6])
def test_huffman_emit_headers_matches_tpubz(tc, tpubz_native):
    """The same header bits and codes: the symbol map, the table and
    selector counts, the unary MTF'd selectors and the delta-coded lengths
    (deltas up to 16, so the pattern splits into two fields)."""
    rng = np.random.default_rng(tc)
    used = rng.random(256) < 0.5
    alpha = int(used.sum()) + 2
    sel = rng.integers(0, tc, 300).astype(np.int64)
    lens = rng.integers(1, 18, (6, alpha)).astype(np.int64)
    lens[0, 1::2] = 17
    lens[0, ::2] = 1
    t_acc, p_acc = TAccum(), BitAccum()
    t_acc.put(5, 3)  # start off a byte boundary
    p_acc.put(5, 3)
    want = thuff.huffman_emit_headers(t_acc, used, sel, lens, tc)
    got = phuff.huffman_emit_headers(p_acc, used, sel, lens, tc)
    assert np.array_equal(got, want)
    assert p_acc.pack() == t_acc.pack()
    assert np.array_equal(phuff.mtf_selectors(sel), thuff.mtf_selectors(sel, tc))


def test_encode_symbol_map_matches_tpubz():
    rng = np.random.default_rng(9)
    maps = [np.zeros(256, bool), np.ones(256, bool), rng.random(256) < 0.1,
            np.arange(256) % 17 == 3]
    for used in maps:
        assert encode_symbol_map(used) == t_symbol_map(used)


@pytest.mark.parametrize("nbits", [1, 7, 31, 32, 33, 1000])
def test_put_words_matches_tpubz(nbits):
    """put_words after a 5-bit field: the bytes of the words' first nbits,
    the pad of the last word masked, as tpubz's; words past the need are
    not read."""
    rng = np.random.default_rng(nbits)
    words = rng.integers(0, 1 << 32, (nbits + 31) // 32 + 2, dtype=np.uint64).astype(np.uint32)
    t_acc, p_acc = TAccum(), BitAccum()
    for acc in (t_acc, p_acc):
        acc.put(0b10110, 5)
        acc.put_words(words, nbits)
        acc.put(1, 1)
    assert p_acc.pack() == t_acc.pack()


def test_huffman_constants_match_tpubz():
    for name in ("GROUP_SIZE", "MAX_GROUPS", "MAX_ALPHA_SIZE", "MAX_CODE_LEN_ENCODE"):
        assert getattr(pconst, name) == getattr(tconst, name)
    for n in (0, 1, 199, 200, 599, 600, 1199, 1200, 2399, 2400, 900_000):
        assert pconst.group_count_for(n) == tconst.group_count_for(n)
    for out in (1, 50, 51, 900_104):
        assert huffman_dev.nsel_cap(out) == thd.nsel_cap(out)
        assert huffman_dev.payload_words_cap(out) == thd.payload_words_cap(out)


def test_wrappers_reject_what_they_do_not_take():
    s = _t(_syms(1), np.int32)
    with pytest.raises(TypeError):
        huffman_dev.chunk_hist(s.to(torch.int64), 10)
    with pytest.raises(TypeError):
        huffman_dev.chunk_hist_batch(s, torch.tensor([10]))
    lens = torch.ones(6, 258, dtype=torch.int32)
    for tc in (1, 7):
        with pytest.raises(ValueError):
            huffman_dev.refine_pass(s, 100, lens, tc)
    with pytest.raises(TypeError):
        huffman_dev.refine_pass(s, 100, lens[:5], 2)
    with pytest.raises(TypeError):
        huffman_dev.refine_pass(s.to(torch.int64), 100, lens, 2)
    with pytest.raises(TypeError):
        huffman_dev.refine_pass(s, 100.0, lens, 2)
    passes = huffman_dev.RefinePasses(s, 100)
    with pytest.raises(ValueError):
        passes.run(np.full((6, 258), 256), 2, 2)
    with pytest.raises(ValueError):
        passes.launch(7)
    with pytest.raises(TypeError):
        huffman_dev.RefinePasses(s.to(torch.int64), 100)
    with pytest.raises(TypeError):
        huffman_dev.pack_payload(s, 100, torch.zeros(3, dtype=torch.int8), lens, lens)
    with pytest.raises(ValueError):
        bitpack.pack_bits_device(torch.zeros(0, dtype=torch.int32),
                                 torch.zeros(0, dtype=torch.int32), 4)

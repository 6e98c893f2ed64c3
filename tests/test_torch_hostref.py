"""The port's scalar codec (``tpubz_torch/hostref``, numpy and Python, none of
the native engine) against tpubz's, on the CPU.

Each ported function takes the same inputs as its counterpart in
``tpubz/hostref`` and ``tpubz/format`` and must give the same outputs,
tolerance 0: the BWT and its inverses, RLE1 and the block cut, the CRC, MTF
with RLE2, the Huffman code-length functions, the refinement, the emission and
the decoder with its trace lines, whole streams, and the decoder's helpers.
The scalar codec is also held against the port's own native engine and its
routes (``compress_cpu``, ``compress(..., device="cpu")``), whose
independent oracle it is. Inputs come from numpy seeds, at most ~200 KB.
Tests that reach ``tpubz.native`` through tpubz's hostref take the
``tpubz_native`` fixture.
"""
import logging
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

import tpubz.format.crc as tcrc
import tpubz.format.symbol_map as tsym
import tpubz.hostref.bitio as tbitio
import tpubz.hostref.block as tblock
import tpubz.hostref.bwt as tbwt
import tpubz.hostref.huffman as thuff
import tpubz.hostref.mtf_rle2 as tmtf
import tpubz.hostref.rle1 as trle1
import tpubz.hostref.stream as tstream
import tpubz.stream.decode as tdecode

import tpubz_torch
import tpubz_torch.format.crc as pcrc
import tpubz_torch.format.symbol_map as psym
import tpubz_torch.hostref.bitio as pbitio
import tpubz_torch.hostref.block as pblock
import tpubz_torch.hostref.bwt as pbwt
import tpubz_torch.hostref.huffman as phuff
import tpubz_torch.hostref.mtf_rle2 as pmtf
import tpubz_torch.hostref.rle1 as prle1
import tpubz_torch.hostref.stream as pstream
import tpubz_torch.stream.decode as pdecode
from tpubz_torch import native as pnative
from tpubz_torch.format.constants import block_budget

from torch_native_guard import tpubz_native  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u8(b) -> np.ndarray:
    return np.frombuffer(bytes(b), np.uint8)


def _runs(seed: int, n_runs: int, lo: int = 4, hi: int = 256) -> np.ndarray:
    """Runs of lo..hi-1 equal bytes, values drawn from 0..3."""
    rng = np.random.default_rng(seed)
    return np.repeat(rng.integers(0, 4, n_runs), rng.integers(lo, hi, n_runs)).astype(np.uint8)


def _text(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy", b"dog",
             b"bzip2", b"block", b"\n"]
    return b" ".join(words[i] for i in rng.integers(0, len(words), n // 4))[:n]


BWT_CASES = {
    "n0": b"",
    "n1": b"x",
    "n2": b"ba",
    "ab_times_k": b"ab" * 500,
    "ab_then_c": b"ab" * 3000 + b"c",
    "run": b"\x07" * 2000,
    "all256": bytes(range(256)) * 8,
    "random": np.random.default_rng(1).integers(0, 256, 5000, dtype=np.uint8).tobytes(),
}


@pytest.mark.parametrize("name", list(BWT_CASES))
def test_bwt_matches_tpubz_and_inverts(name):
    d = _u8(BWT_CASES[name])
    key, last = pbwt.bwt_encode(d)
    tkey, tlast = tbwt.bwt_encode(d)
    assert key == tkey and np.array_equal(last, tlast) and last.dtype == np.uint8
    assert np.array_equal(pbwt.bwt_decode(key, last), d)
    assert np.array_equal(pbwt.bwt_decode_fast(key, last), d)
    assert np.array_equal(pbwt.bwt_decode_fast(key, last), tbwt.bwt_decode_fast(key, last))


def _runs_and_literals(seed: int, n_runs: int) -> np.ndarray:
    """Runs of 4..255 equal bytes (values 0..3), each followed by 1..59
    bytes of 4..255."""
    rng = np.random.default_rng(seed)
    parts = []
    for v, r, n in zip(rng.integers(0, 4, n_runs), rng.integers(4, 256, n_runs),
                       rng.integers(1, 60, n_runs)):
        parts += [np.full(r, v), rng.integers(4, 256, n)]
    return np.concatenate(parts).astype(np.uint8)


RLE1_CASES = {
    # runs of 4..255 between literals, the RLE1 output across two level-1
    # budgets
    "runs_4_255": _runs_and_literals(3, 6000),
    # a 150,000-byte run between text that crosses a budget
    "long_run": _u8(_text(4, 70_000) + b"\x09" * 150_000 + _text(5, 70_000)),
    "text_and_random": _u8(_text(6, 120_000) + np.random.default_rng(6).integers(
        0, 256, 90_000, dtype=np.uint8).tobytes()),
    "short": _u8(b"aaaab"),
    "empty": _u8(b""),
}


@pytest.mark.parametrize("name", list(RLE1_CASES))
def test_rle1_cuts_and_crc_match_native_and_tpubz(name):
    """The numpy cuts equal the native scanner's and tpubz's; the numpy CRC
    of each block equals the native one; rle1_decode inverts."""
    data = RLE1_CASES[name]
    budget = block_budget(1)
    out, seg_out, seg_in = prle1.rle1_encode(data)
    tout, tseg_out, tseg_in = trle1.rle1_encode(data)
    assert np.array_equal(out, tout)
    assert np.array_equal(seg_out, tseg_out) and np.array_equal(seg_in, tseg_in)
    cuts = prle1.split_blocks(out, seg_out, seg_in, budget)
    assert cuts == trle1.split_blocks(tout, tseg_out, tseg_in, budget)
    nout, ncuts = prle1.rle1_blocks(data, budget)
    assert [tuple(map(int, c)) for c in ncuts] == cuts
    for o0, o1, i0, i1 in cuts:
        assert np.array_equal(nout[o0:o1], out[o0:o1])
        assert pcrc.block_crc_numpy(data[i0:i1]) == pcrc.block_crc(data[i0:i1])
        assert pcrc.block_crc_numpy(data[i0:i1]) == tcrc.block_crc_slow(data[i0:i1].tobytes())
    assert np.array_equal(prle1.rle1_decode(out), data)
    assert len(cuts) >= (2 if name in ("runs_4_255", "long_run", "text_and_random") else 0)


def test_crc_of_bytes_like_inputs():
    d = b"123456789"
    for v in (d, bytearray(d), memoryview(d), _u8(d)):
        assert pcrc.block_crc_numpy(v) == 0xFC891918 == tcrc.block_crc(d)
    assert pcrc.block_crc_numpy(b"") == pcrc.block_crc(b"") == 0


def _mtf_inputs():
    rng = np.random.default_rng(7)
    # every pair (x, y) of byte values: most MTF ranks are 255 (symbol 256)
    pairs = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    return {
        "rank_255": pairs.astype(np.uint8).ravel()[:40_000],
        "long_zero_runs": np.repeat(rng.integers(0, 5, 40), rng.integers(1, 9000, 40)).astype(
            np.uint8),
        "one_value": np.full(70_000, 200, np.uint8),
        "random": rng.integers(0, 256, 20_000, dtype=np.uint8),
        "one_byte": _u8(b"q"),
    }


@pytest.mark.parametrize("name", list(_mtf_inputs()))
def test_mtf_rle2_matches_tpubz_and_native(name):
    last = _mtf_inputs()[name]
    rle2, freqs, used = pmtf.mtf_rle2_encode(last)
    trle2, tfreqs, tused = tmtf.mtf_rle2_encode(last)
    assert np.array_equal(rle2, trle2) and rle2.dtype == np.uint16
    assert np.array_equal(freqs, tfreqs) and np.array_equal(used, tused)
    assert int(rle2[-1]) == int(used.sum()) + 1  # the EOB
    nrle2, nfreqs, nused = pnative.mtf_rle2_native(last)
    assert np.array_equal(rle2, nrle2) and np.array_equal(freqs, nfreqs)
    assert np.array_equal(used, nused)
    if name == "rank_255":
        assert int(rle2[:-1].max()) == 256  # rank 255
    symbol_set = np.flatnonzero(used).astype(np.uint8)
    assert np.array_equal(pmtf.mtf_rle2_decode(rle2, symbol_set, last.size), last)
    assert np.array_equal(pmtf.mtf_rle2_decode(rle2[:-1], symbol_set, last.size), last)


def test_zero_run_digits_match_tpubz():
    for n in list(range(1, 600)) + [2 ** 20 - 1, 2 ** 20, 2 ** 21 + 3]:
        assert pmtf.zero_run_digits(n) == tmtf.zero_run_digits(n)


def test_mtf_rle2_decode_refusals():
    syms = np.arange(3, dtype=np.uint8)
    with pytest.raises(ValueError, match="exceeds block size"):
        pmtf.mtf_rle2_decode(np.array([1, 1, 1, 4], np.uint16), syms, 10)
    with pytest.raises(ValueError, match="zero-run bomb"):
        pmtf.mtf_rle2_decode(np.ones(22, np.uint16), syms, 1 << 23)


def _freq_cases():
    rng = np.random.default_rng(8)
    cases = []
    for alpha in (3, 7, 40, 258):
        p = 1.0 / (np.arange(alpha) + 1.0) ** 1.5
        cases.append((rng.multinomial(50_000, p / p.sum()).astype(np.int64), alpha))
    # a few symbols far more frequent than the rest: lengths past 17 before
    # the flattening
    fib = np.array([1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987, 1597,
                    2584, 4181, 6765, 10946, 17711, 28657, 46368], np.int64)
    cases.append((fib, fib.size))
    cases.append((np.zeros(30, np.int64), 30))
    return cases


@pytest.mark.parametrize("case", range(len(_freq_cases())))
def test_code_lengths_match_tpubz_and_native(case):
    freqs, alpha = _freq_cases()[case]
    c = phuff.c_code_lengths(freqs, alpha)
    assert np.array_equal(c, thuff.c_code_lengths(freqs, alpha))
    assert np.array_equal(c, pnative.code_lengths_native(freqs, alpha))
    assert int(c.max()) <= 17
    j = phuff.code_lengths_from_freqs(freqs, alpha)
    assert np.array_equal(j, thuff.code_lengths_from_freqs(freqs, alpha))
    codes = phuff.canonical_codes(c)
    assert np.array_equal(codes, thuff.canonical_codes(c))
    table = phuff.build_decode_table(c)
    ttable = thuff.build_decode_table(c)
    assert table.keys() == ttable.keys()
    for k in table:
        assert np.array_equal(table[k], ttable[k]), k


def _symbols(seed: int, n: int, alpha: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(alpha - 1) + 1.0)
    rle2 = rng.choice(alpha - 1, size=n, p=p / p.sum()).astype(np.uint16)
    rle2[-1] = alpha - 1  # the EOB
    return rle2


@pytest.mark.parametrize("n,alpha", [(150, 4), (500, 30), (1000, 60), (2000, 100),
                                     (30_000, 258)])
def test_refinement_matches_tpubz(n, alpha, tpubz_native):
    """Every table count (2..6), against tpubz's numpy refinement and its
    native engine."""
    rle2 = _symbols(n, n, alpha)
    freqs = np.bincount(rle2, minlength=258).astype(np.int64)
    sel, lens, tc = phuff.assign_selectors_and_lengths(rle2, freqs, alpha)
    tsel, tlens, ttc = thuff.assign_selectors_and_lengths(rle2, freqs, alpha)
    assert tc == ttc and np.array_equal(sel, tsel) and np.array_equal(lens, tlens)
    nsel, nlens, ntc = tpubz_native.refine_stream_native(rle2, alpha, thuff.huffman_iters())
    assert tc == ntc and np.array_equal(sel, nsel) and np.array_equal(lens[:tc], nlens[:tc])
    assert np.array_equal(phuff.mtf_selectors_numpy(sel), phuff.mtf_selectors(sel))


def test_emission_and_table_decode_match_tpubz(tpubz_native):
    """huffman_encode's fields equal tpubz's; reading them back gives the
    tables and the symbols."""
    rle2 = _symbols(9, 4000, 40)
    used = np.zeros(256, bool)
    used[np.arange(38) * 5] = True
    freqs = np.bincount(rle2, minlength=258).astype(np.uint32)
    acc, tacc = pbitio.BitAccum(), tbitio.BitAccum()
    phuff.huffman_encode(acc, rle2, freqs, used)
    thuff.huffman_encode(tacc, rle2, freqs, used)
    assert acc.bit_len == tacc.bit_len
    data, nbits = tacc.pack()
    assert pbitio.pack_bits_numpy(*acc.arrays()) == data
    br = pbitio.BitReader(data + b"\0" * 8)
    words = [br.read(16)]
    words += [br.read(16) for _ in range(bin(words[0]).count("1"))]
    assert np.array_equal(psym.decode_symbol_map(words), np.flatnonzero(used))
    tc, nsel = br.read(3), br.read(15)
    raw = []
    for _ in range(nsel):
        g = 0
        while br.read_bit():
            g += 1
        raw.append(g)
    lengths = phuff.read_huffman_tables(br, 40, tc)
    assert tc == 6 and lengths.shape == (6, 40)
    sel, idx = [], list(range(tc))
    for g in raw:
        sel.append(idx[g])
        idx.insert(0, idx.pop(g))
    tables = [phuff.build_decode_table(lengths[t]) for t in range(tc)]
    got = phuff.huffman_decode_payload(br, tables, np.array(sel), 39)
    assert np.array_equal(got, rle2[:-1]) and br.pos == nbits


def test_bit_reader_and_packer_match_tpubz():
    rng = np.random.default_rng(10)
    bits = rng.integers(1, 25, 5000)
    vals = rng.integers(0, 1 << 24, 5000) & ((1 << bits) - 1)
    packed = pbitio.pack_bits_numpy(vals, bits)
    assert packed == pbitio.pack_bits(vals.astype(np.uint32), bits)
    assert pbitio.pack_bits_numpy(np.zeros(0), np.zeros(0)) == b""
    with pytest.raises(ValueError):
        pbitio.pack_bits_numpy(np.array([1]), np.array([25]))
    br, tbr = pbitio.BitReader(packed), tbitio.BitReader(packed)
    assert np.array_equal(br.peek_bits_array(13, 1000), tbr.peek_bits_array(13, 1000))
    for n in bits[:300]:
        assert br.read_bit() == tbr.read_bit()
        assert br.read(int(n)) == tbr.read(int(n))
        assert br.remaining() == tbr.remaining()
    br.pos = br.bit_len
    with pytest.raises(EOFError):
        br.read_bit()


def test_symbol_map_round_trip_matches_tpubz():
    rng = np.random.default_rng(11)
    for k in (1, 2, 17, 255, 256):
        used = np.zeros(256, bool)
        used[rng.choice(256, k, replace=False)] = True
        words = psym.encode_symbol_map(used)
        assert words == tsym.encode_symbol_map(used)
        assert np.array_equal(psym.decode_symbol_map(words), tsym.decode_symbol_map(words))
        assert np.array_equal(psym.decode_symbol_map(words), np.flatnonzero(used))


@pytest.mark.parametrize("name", ["ab_then_c", "all256", "random"])
def test_block_matches_tpubz_and_decodes(name, tpubz_native):
    block = _u8(BWT_CASES[name])
    crc = zlib.crc32(block) & 0xFFFFFFFF  # any 32 bits
    acc = pblock.encode_block(block, crc)
    tacc = tblock.encode_block(block, crc)
    data, nbits = tacc.pack()
    assert acc.bit_len == nbits and pbitio.pack_bits_numpy(*acc.arrays()) == data
    br = pbitio.BitReader(data + b"\0" * 8)
    assert br.read(48) == 0x314159265359
    raw, got_crc = pblock.decode_block(br, 1)
    assert np.array_equal(raw, prle1.rle1_decode(block)) and got_crc == crc
    assert br.pos == nbits


def _two_block_input() -> bytes:
    """~200 KB that level 1 cuts into two blocks: text, runs, random bytes."""
    rng = np.random.default_rng(12)
    return (_text(12, 90_000) + _runs(13, 150, 4, 256).tobytes()
            + rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes() + bytes(range(256)) * 40)


@pytest.mark.parametrize("level,data", [
    (1, _two_block_input()),
    (9, _text(14, 60_000) + b"\0" * 3000 + bytes(range(256)) * 20),
], ids=["level1_two_blocks", "level9_one_block"])
def test_stream_matches_tpubz_and_the_routes(level, data, tpubz_native, monkeypatch,
                                             tmp_path):
    monkeypatch.setenv("TPUBZ_TORCH_CACHE", str(tmp_path / "cache"))
    got = pstream.compress(data, level)
    assert got == tstream.compress(data, level)
    assert got == tpubz_torch.compress_cpu(data, level)
    assert got == tpubz_torch.compress(data, level, device="cpu")
    blocks = len(pdecode.split_blocks_for_parallel_decode(got))
    assert blocks >= (2 if level == 1 else 1)
    assert pstream.decompress(got) == data


def test_tiny_streams_and_level_checks(sys_bzip2):
    for d in (b"", b"a", b"ab" * 10):
        z = pstream.compress(d, 9)
        assert z == tstream.compress(d, 9) and pstream.decompress(z) == d
    assert len(pstream.compress(b"", 9)) == 14
    for level in (0, 10):
        with pytest.raises(ValueError, match="level"):
            pstream.compress(b"x", level)


def test_decompress_concatenated_and_bzip2_streams(sys_bzip2):
    a = _text(15, 30_000)
    b = np.random.default_rng(15).integers(0, 256, 20_000, dtype=np.uint8).tobytes()
    cat = sys_bzip2(a, 9) + pstream.compress(b, 1) + sys_bzip2(b"", 9) + sys_bzip2(a[:100], 1)
    assert pstream.decompress(cat) == a + b + a[:100]
    assert pstream.decompress(cat) == tstream.decompress(cat)


def _corrupt_cases():
    good = pstream.compress(_text(16, 20_000), 1)
    mid = bytearray(good)
    mid[len(good) // 2] ^= 0x10
    crc = bytearray(good)
    crc[-2] ^= 0x01  # a bit of the stream CRC
    digit = bytearray(good)
    digit[3] = ord("0")
    return {
        "bad_magic": (b"BZx9" + good[4:], "not a bzip2 stream"),
        "block_digit": (bytes(digit), "invalid block size digit"),
        "payload_flip": (bytes(mid), None),
        "stream_crc": (bytes(crc), "stream CRC mismatch"),
        "truncated": (good[: len(good) // 2], None),
    }


@pytest.mark.parametrize("name", list(_corrupt_cases()))
def test_corrupt_streams_raise_tpubz_messages(name):
    """The same exception type and message as tpubz's scalar decoder."""
    data, want = _corrupt_cases()[name]
    with pytest.raises((ValueError, EOFError)) as theirs:
        tstream.decompress(data)
    with pytest.raises((ValueError, EOFError)) as ours:
        pstream.decompress(data)
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)
    if want is not None:
        assert want in str(ours.value)


def test_block_crc_mismatch_message():
    """A block whose stated CRC is wrong: tpubz's message, both numbers."""
    data = _text(17, 5000)
    acc = pbitio.BitAccum()
    for b in b"BZh1":
        acc.put(b, 8)
    acc.extend(*pblock.encode_block(_u8(data), 0x12345678).arrays())
    acc.put(0x177245385090, 48)
    acc.put(0x12345678, 32)
    bad = pbitio.pack_bits_numpy(*acc.arrays())
    with pytest.raises(ValueError) as ours:
        pstream.decompress(bad)
    with pytest.raises(ValueError) as theirs:
        tstream.decompress(bad)
    assert str(ours.value) == str(theirs.value)
    assert str(ours.value).startswith("block CRC mismatch: stream says 0x12345678, got ")


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _traced(logger_name, fn):
    logger = logging.getLogger(logger_name)
    handler = _Lines()
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    try:
        out = fn()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return out, handler.lines


def test_trace_lines_equal_tpubz(sys_bzip2, monkeypatch):
    """On a bzip2 -9 stream, the lines of
    the traced scalar decoder equal tpubz's under TPUBZ_TRACE_BITS, line by
    line; trace=False and an unset variable log no symbol."""
    data = _text(18, 40_000)
    z = sys_bzip2(data, 9)
    monkeypatch.setenv("TPUBZ_TRACE_BITS", "1")
    want_out, want = _traced("tpubz", lambda: tstream.decompress(z))
    got_out, got = _traced("tpubz_torch", lambda: pstream.decompress(z, trace=True))
    assert got_out == want_out == data
    assert got == want and len(got) > 1000
    assert any(m.startswith("sym ") for m in got)
    assert any(m.startswith("block CRC read at bit") for m in got)
    _, env_on = _traced("tpubz_torch", lambda: pstream.decompress(z))
    assert env_on == got
    _, off = _traced("tpubz_torch", lambda: pstream.decompress(z, trace=False))
    monkeypatch.delenv("TPUBZ_TRACE_BITS")
    _, unset = _traced("tpubz_torch", lambda: pstream.decompress(z))
    assert off == unset == [m for m in got if not m.startswith("sym ")]


def test_encode_header_traces_equal_tpubz(tpubz_native):
    block = _u8(_text(19, 8000))
    _, want = _traced("tpubz", lambda: tblock.encode_block(block, 1))
    _, got = _traced("tpubz_torch", lambda: pblock.encode_block(block, 1))
    assert got == want and any("written at bit" in m for m in got)


_NUMPY_ONLY = r"""
import sys
import numpy as np
from tpubz_torch.hostref import stream
from tpubz_torch import native
rng = np.random.default_rng(20)
d = rng.integers(0, 8, 150_000, dtype=np.uint8).tobytes() + b"x" * 5000
z = stream.compress(d, 1)
assert stream.decompress(z, trace=True) == d
maps = open("/proc/self/maps").read()
print(native._lib is None, "libtpubz_torch_native" in maps, len(z))
"""


def test_scalar_codec_loads_no_native_library(tmp_path):
    """A fresh interpreter runs the scalar codec and never loads the port's
    native library (the engine it is the oracle of)."""
    proc = subprocess.run([sys.executable, "-c", _NUMPY_ONLY], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded_none, in_maps, size = proc.stdout.split()
    assert loaded_none == "True" and in_maps == "False" and int(size) > 14


def test_decoder_helpers_match_tpubz(tpubz_native):
    data = _two_block_input() * 2
    z = tpubz_torch.compress_cpu(data, 1)
    offs = pdecode.find_magic_bit_offsets(z)
    assert np.array_equal(offs, tdecode.find_magic_bit_offsets(z))
    footer = 0x177245385090
    assert np.array_equal(pdecode.find_magic_bit_offsets(z, footer),
                          tdecode.find_magic_bit_offsets(z, footer))
    spans = pdecode.split_blocks_for_parallel_decode(z)
    assert spans == tdecode.split_blocks_for_parallel_decode(z) and len(spans) >= 4
    assert spans[0][0] == 32 and spans[-1][1] == len(z) * 8
    assert pdecode.find_magic_bit_offsets(b"BZh9").size == 0

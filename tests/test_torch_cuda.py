"""The port on an NVIDIA GPU: the CUDA kernels against their plain versions,
the BWT on the card against the CPU path, and the device slice against
tpubz's native CPU engine, at levels 1 and 9.

Marked ``cuda``; each test skips unless torch sees a card (decided in the
fixture, never at import). The codec is integer, so every comparison is
exact: tolerance 0. On a machine with a card:
    python -m pytest tests/test_torch_cuda.py
"""
import time

import numpy as np
import pytest

import torch

from tpubz.format.constants import block_budget
from tpubz.hostref.rle1 import rle1_blocks
from tpubz.stream.api import compress_cpu

import tpubz_torch
from tpubz_torch.block.encode import DeviceBlockEncoder
from tpubz_torch.corpus import edge_blocks, mixed_corpus, sidecar_overflow_block
from tpubz_torch.kernels import mtf, rle2
from tpubz_torch.kernels.suffix_sort import bwt_forward

from torch_native_guard import tpubz_native  # noqa: F401 (a fixture)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def port_profile(tmp_path, monkeypatch):
    """A fresh port rig profile per test; streams are device-only on the
    full stage unless a test asks for another route."""
    from tpubz_torch.stream import rigprofile

    monkeypatch.setenv("TPUBZ_TORCH_CACHE", str(tmp_path / "torch_cache"))
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "0")
    monkeypatch.setenv("TPUBZ_DEVICE_STAGE", "full")
    rigprofile.reset_memo()
    yield
    rigprofile.reset_memo()


def _level9_last(name, device):
    """The BWT last column on the card of a level-9 block: the corpus's
    first 900,000 bytes or one of corpus.edge_blocks()."""
    blk = mixed_corpus(1, 2026)[:900_000] if name == "corpus_block0" else edge_blocks()[name]
    data = torch.zeros(900_096, dtype=torch.uint8, device=device)
    data[: len(blk)] = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(device)
    return bwt_forward(data, len(blk))[1], len(blk)


LEVEL9_BLOCKS = ["corpus_block0", "near_periodic", "one_byte_run", "all256"]


@pytest.mark.parametrize("name", LEVEL9_BLOCKS)
def test_mtf_kernels_match_plain_level9(cuda, name):
    """mtf_ranks on the card equals mtf_ranks_ref on the same last column at
    level 9, every lane (pad lanes 0) and the used map, and counts one
    library call."""
    last, n = _level9_last(name, cuda)
    before = mtf.LAUNCHES
    ranks, used = mtf.mtf_ranks(last, n)
    torch.cuda.synchronize()
    assert mtf.LAUNCHES == before + 1
    rranks, rused = mtf.mtf_ranks_ref(last, n)
    assert torch.equal(ranks, rranks) and torch.equal(used, rused)
    if name == "all256":
        assert int(ranks[:n].max()) == 255


@pytest.mark.parametrize("name", LEVEL9_BLOCKS)
def test_rle2_kernels_match_plain_level9(cuda, name):
    """rle2_encode on the card equals rle2_encode_ref on the MTF ranks of a
    level-9 block, with the EOB as a device scalar: every slot, the length
    and the frequencies."""
    last, n = _level9_last(name, cuda)
    ranks, used = mtf.mtf_ranks(last, n)
    eob = used.sum() + 1
    before = rle2.LAUNCHES
    got = rle2.rle2_encode(ranks, n, eob)
    torch.cuda.synchronize()
    assert rle2.LAUNCHES == before + 1
    want = rle2.rle2_encode_ref(ranks, n, eob)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g.long(), w.long())


def _zero_runs(size, seed):
    rng = np.random.default_rng(seed)
    ranks = np.zeros(size, np.int32)
    at = 0
    while at < size:
        at += int(rng.choice([0, 1, 3, 30, 700, 5000, 70_000]))
        if at < size:
            ranks[at] = rng.integers(1, 256)
            at += 1
    return ranks


@pytest.mark.parametrize("n", [0, 1, 4096, 899_999, 900_096])
@pytest.mark.parametrize("seed", [0, 1])
def test_rle2_random_long_zero_runs(cuda, seed, n):
    """Random ranks with zero runs up to many tiles long, nonzero pad lanes,
    and the EOB as a host int and as a device tensor."""
    ranks = torch.from_numpy(_zero_runs(900_096, seed)).to(cuda)
    ranks[n:] = 7
    for eob in (200 + seed, torch.tensor(200 + seed, device=cuda)):
        got = rle2.rle2_encode(ranks, n, eob)
        want = rle2.rle2_encode_ref(ranks, n, eob)
        torch.cuda.synchronize()
        assert all(torch.equal(g.long(), w.long()) for g, w in zip(got, want))


def _three_forms(ranks, n, used):
    """Each RLE2 call form on one row, every output as int64: the one-block
    call with the EOB from the used map and as a device scalar, the batched
    call (a batch of one row) and the lean call."""
    eob = used.sum() + 1
    forms = {
        "used": rle2.rle2_encode_used(ranks, n, used),
        "eob": rle2.rle2_encode(ranks, n, eob),
        "batch": rle2.rle2_encode_batch(ranks[None], [n], eob.reshape(1).int()),
    }
    from tpubz_torch.kernels import compact

    forms["lean"] = compact.rle2_compact(ranks, n, used)
    torch.cuda.synchronize()
    return {k: [t.long() for t in v] for k, v in forms.items()}


def _held_forms(got, ranks, n, used):
    """_three_forms' outputs equal the plain versions on the CPU."""
    from tpubz_torch.kernels import compact

    c_ranks, c_used = ranks.cpu(), used.cpu()
    want = rle2.rle2_encode_ref(c_ranks, n, c_used.sum() + 1)
    for form in ("used", "eob"):
        assert all(torch.equal(g.cpu(), w.long()) for g, w in zip(got[form], want)), form
    assert all(torch.equal(g[0].cpu(), w.long()) for g, w in zip(got["batch"], want))
    lean = compact.rle2_compact_ref(c_ranks, n, c_used)
    assert all(torch.equal(g.cpu(), w.long()) for g, w in zip(got["lean"], lean))


@pytest.mark.parametrize("source", ["corpus_block0", "zero_runs"])
def test_rle2_forms_repeat_identically(cuda, source):
    """The look-back's races: the same call 20 times, on the corpus block's
    MTF ranks and on random ranks with zero runs up to 70,000 long, gives
    identical outputs in every form, equal to the plain versions."""
    if source == "corpus_block0":
        last, n = _level9_last(source, cuda)
        ranks, used = mtf.mtf_ranks(last, n)
    else:
        n = 899_999
        ranks = torch.from_numpy(_zero_runs(900_096, 3)).to(cuda)
        ranks[n:] = 5
        used = torch.ones(256, dtype=torch.bool, device=cuda)
    first = _three_forms(ranks, n, used)
    _held_forms(first, ranks, n, used)
    for _ in range(19):
        again = _three_forms(ranks, n, used)
        for form, outs in first.items():
            assert all(torch.equal(a, b) for a, b in zip(outs, again[form])), form


def test_transform_takes_the_eob_from_the_used_map(cuda):
    """DeviceBlockEncoder.transform's RLE2 (the EOB counted on the card from
    the used map) equals rle2_encode(ranks, n, used.sum() + 1), and launches
    no conversion of the symbols: they come back as uint16."""
    blk = np.frombuffer(edge_blocks()["all256"], np.uint8)
    enc = DeviceBlockEncoder(9, cuda)
    key, syms, rle2_len, freqs, used = enc.transform(blk)
    last = enc.transform_bwt(blk)[1]
    ranks, used2 = mtf.mtf_ranks(last, blk.size)
    want = rle2.rle2_encode(ranks, blk.size, used2.sum() + 1)
    torch.cuda.synchronize()
    assert torch.equal(used, used2) and syms.dtype == torch.uint16
    assert all(torch.equal(g.long(), w.long()) for g, w in zip((syms, rle2_len, freqs), want))
    assert int(syms[int(rle2_len) - 1]) == 257


@pytest.mark.parametrize("n,N", [(0, 4096), (1, 4096), (2, 4096), (0, 16), (2, 16),
                                 (5000, 12_288), (899_997, 900_096)])
def test_rle2_forms_at_small_and_ragged_lengths(cuda, n, N):
    """n = 0, 1, 2, and n not a multiple of the 4096-rank tile with nonzero
    pad lanes after it, on all three forms, against the plain versions."""
    rng = np.random.default_rng(n + N)
    r = np.where(rng.random(N) < 0.3, rng.integers(1, 256, N), 0).astype(np.int32)
    r[n:] = 255
    ranks = torch.from_numpy(r).to(cuda)
    used = torch.from_numpy(rng.random(256) < 0.5).to(cuda)
    _held_forms(_three_forms(ranks, n, used), ranks, n, used)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    last = torch.zeros(1024, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        mtf.mtf_ranks(last, 10, chunk=128)
    with pytest.raises(ValueError):
        mtf.mtf_ranks(last[::2], 10)
    ranks = torch.zeros(1025, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        rle2.rle2_encode(ranks[1:], 10, 2)
    with pytest.raises(TypeError):
        rle2.rle2_encode(ranks.long(), 10, 2)


def test_device_stream_matches_compress_cpu(cuda):
    """Multi-block level-1 stream on the card equals the native CPU engine,
    every block on the device, and round-trips."""
    rng = np.random.default_rng(9)
    d = (
        bytes(rng.integers(0, 256, 150_000, dtype=np.uint8))
        + b"ab" * 100_000 + b"c"
        + bytes(range(256)) * 400
    )
    before = (mtf.LAUNCHES, rle2.LAUNCHES)
    got = tpubz_torch.compress(d, 1, device="cuda")
    blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
    assert blocks >= 4
    assert min(mtf.LAUNCHES - before[0], rle2.LAUNCHES - before[1]) >= blocks
    assert got == compress_cpu(d, 1)
    assert tpubz_torch.decompress(got) == d


def _level9_data() -> bytes:
    """3 MiB of the seeded mixed corpus, then the edge blocks: near-periodic,
    a 900k run of one byte, and one that reaches MTF rank 255."""
    return mixed_corpus(3, 7) + b"".join(edge_blocks().values())


def test_level9_blocks_match_native(cuda, tpubz_native):
    """Every level-9 block: fetch(transform(blk)) on the card gives the key,
    symbols, frequencies and used map of tpubz.native.block_transform_native."""
    block_transform_native = tpubz_native.block_transform_native
    arr = np.frombuffer(_level9_data(), np.uint8)
    out, blocks = rle1_blocks(arr, block_budget(9))
    assert len(blocks) == 5
    enc = DeviceBlockEncoder(9, cuda)
    for o0, o1, _, _ in blocks:
        blk = out[o0:o1]
        key, syms, rl, freqs, used = enc.fetch(enc.transform(blk))
        nkey, nsyms, nfreqs, nused = block_transform_native(blk)
        assert key == nkey and rl == nsyms.size
        assert np.array_equal(syms, nsyms)
        assert np.array_equal(freqs, nfreqs.astype(np.int64))
        assert np.array_equal(used, nused)


def test_level9_stream_matches_compress_cpu(cuda):
    """The level-9 stream on the card equals compress_cpu byte for byte, and
    every block launched the MTF and RLE2 kernels."""
    d = _level9_data()
    before = (mtf.LAUNCHES, rle2.LAUNCHES)
    got = tpubz_torch.compress(d, 9, device="cuda")
    blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
    assert blocks == 5
    assert min(mtf.LAUNCHES - before[0], rle2.LAUNCHES - before[1]) >= blocks
    assert got == compress_cpu(d, 9)
    assert tpubz_torch.decompress(got) == d


def _bitonic_inputs(length, dtype, seed, device):
    """Seeded keys with many duplicates (values below length / 4) and a
    permutation payload, on the card."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(length // 4, 2), length).astype(dtype)
    payload = rng.permutation(length).astype(np.int32)
    return torch.from_numpy(keys).to(device), torch.from_numpy(payload).to(device)


@pytest.mark.parametrize("op", ["1op", "2op"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("log2n", [10, 17, 20])
def test_bitonic_matches_plain(cuda, log2n, dtype, op):
    """bitonic_1op / bitonic_2op on the card equal their plain versions on
    the same tensors, exactly, payload order on duplicate keys included;
    one library call per sort, the inputs untouched."""
    from tpubz_torch.kernels import bitonic

    keys, payload = _bitonic_inputs(1 << log2n, dtype, log2n, cuda)
    original = keys.clone()
    before = bitonic.LAUNCHES
    if op == "1op":
        got = bitonic.bitonic_1op(keys)
        torch.cuda.synchronize()
        assert torch.equal(got, bitonic.bitonic_1op_ref(keys))
    else:
        gk, gp = bitonic.bitonic_2op(keys, payload)
        torch.cuda.synchronize()
        rk, rp = bitonic.bitonic_2op_ref(keys, payload)
        assert torch.equal(gk, rk) and torch.equal(gp, rp)
        got = gk
    assert bitonic.LAUNCHES == before + 1
    assert torch.equal(got, torch.sort(keys).values)
    assert torch.equal(keys, original)


def _periodic_round_keys(device):
    """The int64 keys of the first doubling round of a near-periodic level-9
    block (b"ab" * 449_000 + b"c") less their positions, padded to 2^20
    with INT64_MAX: long runs of equal keys."""
    from tpubz_torch.kernels import suffix_sort

    blk = edge_blocks()["near_periodic"]
    data = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(device)
    keys = torch.full((1 << 20,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=device)
    keys[: len(blk)] = suffix_sort.seed_keys(data) >> suffix_sort.KEY_LO
    return keys


@pytest.mark.parametrize("shape", [(12, 4, 4), (13, 4, 5), (13, 3, 4), (14, 4, 5)],
                         ids=["t12f4", "t13f5", "t13r3", "t14"])
@pytest.mark.parametrize("keys_kind", ["i32_three_values", "i64_three_values",
                                       "i64_periodic_round"])
def test_bitonic_plans_match_plain_at_2_20(cuda, monkeypatch, keys_kind, shape):
    """At 2^20, under the default plan and the other measured plan shapes,
    both sorts equal their plain versions exactly on duplicate-heavy keys
    (three values, int32 and int64) and on the round keys of a periodic
    block, payload order on equal keys included."""
    from tpubz_torch.kernels import bitonic

    tile_log2, regs_log2, fuse = shape
    monkeypatch.setattr(bitonic, "TILE_LOG2", tile_log2)
    monkeypatch.setattr(bitonic, "REGS_LOG2", regs_log2)
    monkeypatch.setattr(bitonic, "FUSE", fuse)
    n = 1 << 20
    rng = np.random.default_rng(len(keys_kind))
    if keys_kind == "i64_periodic_round":
        keys = _periodic_round_keys(cuda)
    else:
        dtype = np.int32 if keys_kind.startswith("i32") else np.int64
        keys = torch.from_numpy(rng.integers(0, 3, n).astype(dtype)).to(cuda)
    payload = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    before = bitonic.PASS_LAUNCHES
    gk, gp = bitonic.bitonic_2op(keys, payload)
    g1 = bitonic.bitonic_1op(keys)
    torch.cuda.synchronize()
    launches = len(bitonic.plan(bitonic.network(20), 20, tile_log2, regs_log2, fuse))
    assert bitonic.PASS_LAUNCHES - before == 2 * launches
    rk, rp = bitonic.bitonic_2op_ref(keys, payload)
    assert torch.equal(gk, rk) and torch.equal(gp, rp)
    assert torch.equal(g1, bitonic.bitonic_1op_ref(keys))


@pytest.mark.parametrize("js", [[19, 18], [9, 8, 7, 6, 5, 4, 3, 2], [0, 15, 3, 11, 10, 12, 1]],
                         ids=["row2", "lane8", "mixed"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["i32", "i64"])
def test_stage_passes_match_plain(cuda, dtype, js):
    """stage_passes in place on 2^20 keys equals stage_passes_ref, for the
    probe's row2 and lane8 cases and a mixed order of long and short
    distances."""
    from tpubz_torch.kernels import bitonic

    keys, _ = _bitonic_inputs(1 << 20, dtype, len(js), cuda)
    want = bitonic.stage_passes_ref(keys.clone(), js)
    got = keys.clone()
    assert bitonic.stage_passes(got, js) is got
    torch.cuda.synchronize()
    assert torch.equal(got, want)


_rng = np.random.default_rng(777)
_BWT_CASES = {
    "banana": b"banana" * 30,
    "aaaa": b"aaaa" * 100,
    "n1": b"x",
    "n2_same": b"zz",
    "n2": b"ba",
    "n3": b"aba",
    "n255": bytes(_rng.integers(0, 4, 255, dtype=np.uint8)),
    "n256": bytes(_rng.integers(0, 4, 256, dtype=np.uint8)),
    "n257": bytes(_rng.integers(0, 4, 257, dtype=np.uint8)),
    "n777": bytes(_rng.integers(0, 20, 777, dtype=np.uint8)),
    "n2047": bytes(_rng.integers(0, 2, 2047, dtype=np.uint8)),
    "n2049": bytes(_rng.integers(0, 2, 2049, dtype=np.uint8)),
    "near_periodic": b"ab" * 500 + b"c",
    "period7": b"abcabca" * 300,
    "period64_flip": bytes(_rng.integers(0, 256, 64, dtype=np.uint8)) * 20 + b"!" + bytes(63),
    "period257": bytes(_rng.integers(0, 5, 257, dtype=np.uint8)) * 12,
    "all256": bytes(range(256)) * 4,
    "pow2": bytes(_rng.integers(0, 3, 4096, dtype=np.uint8)),
    "text": b"the quick brown fox jumps over the lazy dog; " * 90 + b"pack my box.",
}
_BWT_TIED = {"banana", "aaaa", "n2_same", "period7", "period257", "all256", "level9_one_byte_run",
             "level9_all256"}


def _bwt_case(case):
    if case == "level9_corpus":
        return mixed_corpus(1, 3)[:900_000]
    if case.startswith("level9_"):
        return edge_blocks()[case.removeprefix("level9_")]
    return _BWT_CASES[case]


@pytest.mark.parametrize("case", list(_BWT_CASES) + [
    "level9_corpus", "level9_near_periodic", "level9_one_byte_run", "level9_all256"])
def test_bwt_forward_on_card_matches_cpu(cuda, case, tpubz_native):
    """bwt_forward on the card (one library call: the doubling rounds on the
    radix sort of csrc/radix.cuh) gives the key and last column of the plain
    version on the card and of tpubz's native BWT, pad lanes zero, with one
    counted call, a radix sort in round 0 and in each later round whose
    large list was not empty, as the card counted them, and no bitonic
    sort; small cases also equal the plain version on the CPU."""
    from tpubz_torch.kernels import bitonic, radix, suffix_sort

    c = _bwt_case(case)
    N = 900_096 if case.startswith("level9_") else 4352
    data = torch.zeros(N, dtype=torch.uint8)
    data[: len(c)] = torch.frombuffer(bytearray(c), dtype=torch.uint8)
    on_card = data.to(cuda)
    before = (suffix_sort.LAUNCHES, suffix_sort.ROUNDS_RUN, radix.SORTS, dict(bitonic.CALLS))
    key, last, call = suffix_sort.bwt_forward_async(on_card, len(c))
    call.finish()
    rounds = suffix_sort.ROUNDS_RUN - before[1]
    assert suffix_sort.LAUNCHES == before[0] + 1
    assert 1 <= rounds <= suffix_sort.call_sizes(len(c))[2]
    large_rounds = 1 + sum(int(w[3] > 0) for w in call.rows[0]["words"][:-1])
    assert radix.SORTS == before[2] + large_rounds and bitonic.CALLS == before[3]
    assert key.device.type == "cuda" and key.dtype == torch.int64 and key.dim() == 0
    rkey, rlast = suffix_sort.bwt_forward_ref(on_card, len(c))
    assert int(key) == int(rkey) and torch.equal(last, rlast)
    assert not last[len(c):].any()
    nkey, nlast = tpubz_native.bwt_native(np.frombuffer(c, np.uint8))
    assert int(key) == nkey and np.array_equal(last[: len(c)].cpu().numpy(), nlast)
    if not case.startswith("level9_"):
        ckey, clast = suffix_sort.bwt_forward_ref(data, len(c))
        assert int(key) == int(ckey) and torch.equal(last.cpu(), clast)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 100, 1 << 10, 900_000, 1 << 20])
def test_bwt_call_sizes(cuda, n):
    """The library's sizes for a block of n bytes: the cap covers n
    (5 * 2^(cap-2) >= n, the round after leaves no rotation or splits no
    class) and is the least that does, every round has its pinned words,
    the scratch holds at least the two key buffers, rank, sa and the two
    active lists of n rotations, and a round runs the plain version's radix
    passes."""
    from tpubz_torch.kernels import radix, suffix_sort

    nbytes, words, cap, passes = suffix_sort.call_sizes(n)
    assert 5 << (cap - 2) >= n and (cap == 2 or 5 << (cap - 3) < n)
    assert cap == suffix_sort.round_cap(n) and words >= 3 * cap
    assert nbytes > 32 * n
    assert passes == len(radix.passes(suffix_sort.KEY_LO, suffix_sort.KEY_HI, radix.DIGIT_BITS))


def _radix_keys(kind, cuda):
    """Keys for the radix sort at the BWT's width: random 60-bit keys at
    n = 900,000, or the keys of a real round (round 1 of the corpus's first
    level-9 block, from the plain version)."""
    from tpubz_torch.kernels import suffix_sort

    if kind == "random":
        rng = np.random.default_rng(900)
        return torch.from_numpy(rng.integers(0, 1 << 60, 900_000, dtype=np.int64)).to(cuda)
    blk = torch.frombuffer(bytearray(mixed_corpus(1, 2026)[:900_000]), dtype=torch.uint8)
    return suffix_sort.round_keys(blk.to(cuda), 1)


@pytest.mark.parametrize("kind", ["random", "round1"])
def test_radix_sort_matches_plain(cuda, kind):
    """radix_sort on the card equals radix_sort_ref by bits 20-59, exactly
    (equal fields in input order), one library call in the plain version's
    digits, the input untouched; also at sizes around its 4096-key tile."""
    from tpubz_torch.kernels import radix

    bits = radix.DIGIT_BITS
    assert radix.library_sizes(1)[1] == bits
    keys = _radix_keys(kind, cuda)
    original = keys.clone()
    before = (radix.LAUNCHES, radix.PASS_LAUNCHES)
    got = radix.radix_sort(keys, 20, 60)
    torch.cuda.synchronize()
    assert radix.LAUNCHES == before[0] + 1
    assert radix.PASS_LAUNCHES - before[1] == 1 + len(radix.passes(20, 60, bits))
    assert torch.equal(got, radix.radix_sort_ref(keys, 20, 60, bits))
    assert torch.equal(keys, original)
    for n in (1, 2, 4095, 4096, 4097, 3 * 4096 + 5):
        part = keys[:n].contiguous()
        assert torch.equal(radix.radix_sort(part, 20, 60), radix.radix_sort_ref(part, 20, 60, bits))
    for lo, hi in ((0, 63), (7, 13)):
        assert torch.equal(radix.radix_sort(keys, lo, hi), radix.radix_sort_ref(keys, lo, hi, bits))


def test_bwt_forward_block_after_a_periodic_block(cuda):
    """Nothing of a block's state outlives its call: an ordinary block gives
    the same key and column after a periodic block (ties, a stall round) and
    after a near-periodic one (many rounds) as on its own."""
    N = 900_096
    blocks = {"corpus": mixed_corpus(1, 5)[:900_000], **edge_blocks()}
    data = {}
    for name, c in blocks.items():
        data[name] = torch.zeros(N, dtype=torch.uint8, device=cuda)
        data[name][: len(c)] = torch.frombuffer(bytearray(c), dtype=torch.uint8).to(cuda)
    n = len(blocks["corpus"])
    key, last = bwt_forward(data["corpus"], n)
    for name in ("one_byte_run", "all256", "near_periodic"):
        bwt_forward(data[name], len(blocks[name]))
        again_key, again_last = bwt_forward(data["corpus"], n)
        torch.cuda.synchronize()
        assert int(again_key) == int(key) and torch.equal(again_last, last)


def test_bwt_forward_two_threads_two_encoders(cuda):
    """Two encoders on two threads, each under its own stream, give the
    bytes that one encoder gives block by block: the BWT's calls share no
    scratch, tickets or status words."""
    from concurrent.futures import ThreadPoolExecutor

    arr = np.frombuffer(_level9_data(), np.uint8)
    out, cuts = rle1_blocks(arr, block_budget(9))
    blocks = [out[o0:o1] for o0, o1, _, _ in cuts]
    one = DeviceBlockEncoder(9, cuda)
    want = [one.fetch_bwt(one.transform_bwt(b)) for b in blocks]

    def run(order):
        enc = DeviceBlockEncoder(9, cuda)
        with torch.cuda.stream(enc.stream):
            return {i: enc.fetch_bwt(enc.transform_bwt(blocks[i])) for i in order}

    idx = list(range(len(blocks)))
    with ThreadPoolExecutor(2) as ex:
        got = [f.result() for f in (ex.submit(run, idx * 2), ex.submit(run, idx[::-1] * 2))]
    for res in got:
        for i, (key, last) in res.items():
            assert key == want[i][0] and np.array_equal(last, want[i][1])


def _card_block(name, cuda):
    blk = mixed_corpus(1, 5)[:900_000] if name == "corpus" else edge_blocks()[name]
    data = torch.zeros(900_096, dtype=torch.uint8, device=cuda)
    data[: len(blk)] = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(cuda)
    return data, len(blk)


@pytest.mark.parametrize("name", ["corpus", "near_periodic", "one_byte_run"])
def test_bwt_call_time_on_the_card(cuda, name):
    """A finished call's device_ns, from the card's clock at the start of
    bwt_setup and at the end of bwt_last_column: above 0, and below the
    host's wall time of the call followed by a synchronise. A stream's
    blocks carry it on their fetch.wait spans."""
    from tpubz_torch import spans
    from tpubz_torch.kernels import suffix_sort

    data, n = _card_block(name, cuda)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        _, _, call = suffix_sort.bwt_forward_async(data, n)
        call.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter_ns() - t0
        assert 0 < call.device_ns < wall
    with spans.recording() as rec:
        tpubz_torch.compress(mixed_corpus(4, 8), 9, device="cuda")
    waits = [s for s in rec.spans if s.name == "fetch.wait"]
    assert len(waits) >= 4 and all(s.attrs["bwt_device_ns"] > 0 for s in waits)


def test_bwt_call_returns_before_the_card_and_finishes_at_the_fetch(cuda):
    """The encoder's BWT call returns once its last column is enqueued, with
    no host wait inside it: it is counted as enqueued, and its rounds are
    counted, and its buffers released, when the block's own fetch has
    waited on the stream."""
    from tpubz_torch.kernels import suffix_sort

    blk = np.frombuffer(mixed_corpus(1, 6)[:900_000], np.uint8)
    enc = DeviceBlockEncoder(9, cuda)
    want = bwt_forward(enc.upload(blk), blk.size)
    before = (suffix_sort.ROUNDS_RUN, suffix_sort.LAUNCHES, suffix_sort.HOST_US["wait"])
    with torch.cuda.stream(enc.stream):
        out = enc.transform_bwt(blk)
        assert out.bwt.rows is None
        assert (suffix_sort.ROUNDS_RUN, suffix_sort.LAUNCHES) == (before[0], before[1] + 1)
        key, last = enc.fetch_bwt(out)
    assert out.bwt.rows is not None and out.bwt.rows[0]["rounds"] >= 2
    assert suffix_sort.ROUNDS_RUN > before[0] and suffix_sort.HOST_US["wait"] == before[2]
    assert key == int(want[0]) and np.array_equal(last, want[1][: blk.size].cpu().numpy())


def test_a_fetch_finishes_only_its_own_blocks_bwt_call(cuda):
    """Two encoders on two streams, both calls passed by the card: the
    first fetch finishes its own block's BWT call and counts its rounds
    only; the other call stays unfinished until its own fetch."""
    from tpubz_torch.kernels import suffix_sort

    blk = np.frombuffer(mixed_corpus(1, 7)[:900_000], np.uint8)
    a, b = DeviceBlockEncoder(9, cuda), DeviceBlockEncoder(9, cuda)
    with torch.cuda.stream(b.stream):
        out_b = b.transform_bwt(blk)
    with torch.cuda.stream(a.stream):
        out_a = a.transform_bwt(blk)
    torch.cuda.synchronize()
    rounds = suffix_sort.ROUNDS_RUN
    with torch.cuda.stream(a.stream):
        key_a, last_a = a.fetch_bwt(out_a)
    assert out_b.bwt.done() and out_b.bwt.rows is None
    assert suffix_sort.ROUNDS_RUN == rounds + out_a.bwt.rows[0]["rounds"]
    with torch.cuda.stream(b.stream):
        key_b, last_b = b.fetch_bwt(out_b)
    assert suffix_sort.ROUNDS_RUN == rounds + 2 * out_a.bwt.rows[0]["rounds"]
    assert key_a == key_b and np.array_equal(last_a, last_b)


@pytest.mark.parametrize("streams", [1, 2])
def test_bwt_buffers_live_until_the_stream_passes_the_call(cuda, streams):
    """Right after a call returns, while the card still runs it behind
    long work, new pinned and device tensors of its buffers' sizes (on its
    stream, or on a second stream for a second call) are filled: the
    call's record and outputs are the plain version's, and no new tensor
    was written by the card."""
    from tpubz_torch.kernels import suffix_sort

    long_data, long_n = _card_block("near_periodic", cuda)
    data, n = _card_block("corpus", cuda)
    rkey, rlast = suffix_sort.bwt_forward_ref(data, n)
    nbytes, words, _, _ = suffix_sort.call_sizes(n)
    side = [torch.cuda.Stream(cuda) for _ in range(streams)]
    calls, junk, in_flight, held = [], [], [], []
    for st in side:
        with torch.cuda.stream(st):
            held.append(suffix_sort.bwt_forward_async(long_data, long_n)[2])
            torch.cuda._sleep(100_000_000)  # the card busy for tens of ms
            key, last, call = suffix_sort.bwt_forward_async(data, n)
            calls.append((key, last, call))
            in_flight.append(not call.done())
            for _ in range(3):
                pinned = torch.full((words,), -5, dtype=torch.int32, pin_memory=True)
                dev = torch.full((nbytes,), 7, dtype=torch.uint8, device=cuda)
                junk.append((pinned, dev))
    assert all(in_flight)
    for call in held + [c for _, _, c in calls]:
        call.finish()
    torch.cuda.synchronize()
    for key, last, call in calls:
        assert int(key) == int(rkey) and torch.equal(last, rlast)
        assert call.rows[0]["rounds"] >= 2 and call.rows[0]["active"] >= n
    for pinned, dev in junk:
        assert bool((pinned == -5).all()) and bool((dev == 7).all())


def test_bwt_cap_error_still_raises(cuda):
    """A round cap below what a block needs (no input reaches the real one)
    raises from the one-block call, from the batch naming its row, and from
    the finish of a call left in flight; the next call runs as before."""
    from tpubz_torch.kernels import suffix_sort

    data, n = _card_block("near_periodic", cuda)
    with pytest.raises(RuntimeError, match="no fixpoint"):
        bwt_forward(data, n, cap=3)
    random = torch.from_numpy(np.random.default_rng(3).integers(0, 256, 900_096, dtype=np.uint8))
    rows = torch.stack([random.to(cuda), data])  # random bytes stop after two rounds
    with pytest.raises(RuntimeError, match="row 1"):
        suffix_sort.bwt_forward_batch(rows, [900_000, n], cap=3)
    _, _, call = suffix_sort.bwt_forward_async(data, n, cap=3)
    with pytest.raises(RuntimeError, match="no fixpoint"):
        call.finish()
    with pytest.raises(RuntimeError, match="no fixpoint"):
        call.finish()  # finished once; it raises again
    key, last = bwt_forward(data, n)
    rkey, rlast = suffix_sort.bwt_forward_ref(data, n)
    assert int(key) == int(rkey) and torch.equal(last, rlast)


def test_bwt_forward_rejects_what_the_kernels_do_not_take(cuda):
    data = torch.zeros(1024, dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        bwt_forward(data[::2], 10)
    with pytest.raises(TypeError):
        bwt_forward(data.int(), 10)
    with pytest.raises(ValueError):
        bwt_forward(data, 1025)
    key, last = bwt_forward(data, 0)
    assert int(key) == 0 and not last.any()


def test_fetch_bwt_pinned_copy_matches_sync(cuda, tpubz_native):
    """fetch_bwt's non-blocking copy into pinned memory, waited on through
    its event on another thread, equals a synchronous .cpu() of the same
    tensors; so does fetch's."""
    block_transform_native = tpubz_native.block_transform_native
    from concurrent.futures import ThreadPoolExecutor

    blk = np.frombuffer(mixed_corpus(1, 4)[:900_000], np.uint8)
    enc = DeviceBlockEncoder(9, cuda)
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        out = enc.transform_bwt(blk)
        pending = enc.fetch_bwt_async(out)
        full = enc.transform(blk)
        pending_full = enc.fetch_async(full)
    with ThreadPoolExecutor(1) as ex:
        key, last = ex.submit(pending.result).result()
        fkey, syms, rl, freqs, used = ex.submit(pending_full.result).result()
    torch.cuda.synchronize()
    assert key == int(out[0].cpu()) == fkey
    assert np.array_equal(last, out[1].cpu().numpy()[: blk.size])
    assert rl == int(full[2].cpu())
    assert np.array_equal(syms, full[1][:rl].cpu().numpy().astype(np.uint16))
    assert np.array_equal(freqs, full[3].cpu().numpy()) and np.array_equal(used, full[4].cpu().numpy())
    nkey, nsyms, _, _ = block_transform_native(blk)
    assert key == nkey and np.array_equal(syms, nsyms)


@pytest.mark.parametrize("route", ["bwt", "hybrid", "compress_file"])
def test_level9_routes_match_compress_cpu(cuda, route, monkeypatch, tmp_path):
    """The bwt stage (device-only), the default hybrid and compress_file on
    the card each equal compress_cpu at level 9, byte for byte."""
    from tpubz_torch.kernels import suffix_sort
    from tpubz_torch.stream.files import compress_file

    d = _level9_data()
    calls = suffix_sort.LAUNCHES
    if route == "bwt":
        monkeypatch.setenv("TPUBZ_DEVICE_STAGE", "bwt")
        launches = (mtf.LAUNCHES, rle2.LAUNCHES)
        got = tpubz_torch.compress(d, 9, device="cuda")
        assert (mtf.LAUNCHES, rle2.LAUNCHES) == launches
    elif route == "hybrid":
        monkeypatch.delenv("TPUBZ_DEVICE_STAGE")
        monkeypatch.delenv("TPUBZ_HYBRID_CPU")
        got = tpubz_torch.compress(d, 9, device="cuda")
        assert tpubz_torch.stream.api.last_stream_stats["engine"] == "hybrid"
    else:
        src, dst = tmp_path / "in", tmp_path / "in.bz2"
        src.write_bytes(d)
        compress_file(str(src), str(dst), 9, device="cuda")
        got = dst.read_bytes()
    st = tpubz_torch.stream.api.last_stream_stats
    assert st["dev_blocks"] >= 1
    assert suffix_sort.LAUNCHES - calls == st["dev_blocks"]
    assert got == compress_cpu(d, 9)


# ---- the multi-process path's batched kernels ----

_BATCHES = {
    1: ["corpus_odd"],
    3: ["near_periodic", "pad", "all256"],
    4: ["corpus_block0", "overflow", "random_odd", "pad"],
}


def _batch_rows(B, device):
    """B level-9 rows on the card: (data uint8[B, 900096], n list)."""
    from tpubz_torch.corpus import sidecar_overflow_block

    rng = np.random.default_rng(40 + B)
    make = {
        "corpus_odd": lambda: mixed_corpus(1, 11)[:899_999],
        "corpus_block0": lambda: mixed_corpus(1, 2026)[:900_000],
        "near_periodic": lambda: edge_blocks()["near_periodic"],
        "all256": lambda: edge_blocks()["all256"],
        "overflow": lambda: sidecar_overflow_block(),
        "random_odd": lambda: rng.bytes(899_001),
        "pad": lambda: b"\x00",
    }
    data = torch.zeros(B, 900_096, dtype=torch.uint8)
    n = []
    for b, name in enumerate(_BATCHES[B]):
        row = make[name]()
        data[b, : len(row)] = torch.frombuffer(bytearray(row), dtype=torch.uint8)
        n.append(len(row))
    return data.to(device), n


@pytest.mark.parametrize("B", list(_BATCHES))
def test_bwt_forward_batch_on_card(cuda, B):
    """The batched BWT (one library call) equals its plain version on the
    card and the one-block call row by row; a pad row takes no round, and
    the rounds are those of the one-block calls of the other rows."""
    from tpubz_torch.kernels import suffix_sort

    data, n = _batch_rows(B, cuda)
    before = (suffix_sort.BATCH_LAUNCHES, suffix_sort.ROUNDS_RUN)
    keys, last = suffix_sort.bwt_forward_batch(data, n)
    torch.cuda.synchronize()
    assert suffix_sort.BATCH_LAUNCHES == before[0] + 1
    batch_rounds = suffix_sort.ROUNDS_RUN - before[1]
    rkeys, rlast = suffix_sort.bwt_forward_batch_ref(data, n)
    assert torch.equal(keys, rkeys) and torch.equal(last, rlast)
    one_rounds = 0
    for b, nb in enumerate(n):
        r0 = suffix_sort.ROUNDS_RUN
        key, col = bwt_forward(data[b], nb)
        torch.cuda.synchronize()
        if nb > 1:
            one_rounds += suffix_sort.ROUNDS_RUN - r0
        assert int(key) == int(keys[b]) and torch.equal(col, last[b])
    assert batch_rounds == one_rounds


@pytest.mark.parametrize("B", list(_BATCHES))
def test_mtf_ranks_batch_on_card(cuda, B):
    """The batched MTF kernels equal their plain version on the card and
    the one-block kernels row by row (ranks of the valid lanes, used)."""
    from tpubz_torch.kernels import suffix_sort

    data, n = _batch_rows(B, cuda)
    _, last = suffix_sort.bwt_forward_batch(data, n)
    before = mtf.BATCH_LAUNCHES
    ranks, used = mtf.mtf_ranks_batch(last, n)
    torch.cuda.synchronize()
    assert mtf.BATCH_LAUNCHES == before + 1
    rranks, rused = mtf.mtf_ranks_batch_ref(last, n)
    assert torch.equal(used, rused)
    for b, nb in enumerate(n):
        assert torch.equal(ranks[b, :nb], rranks[b, :nb])
        one_ranks, one_used = mtf.mtf_ranks(last[b].contiguous(), nb)
        assert torch.equal(ranks[b, :nb], one_ranks[:nb]) and torch.equal(used[b], one_used)


@pytest.mark.parametrize("B", list(_BATCHES))
def test_rle2_encode_batch_on_card(cuda, B):
    """The batched RLE2 kernels, the EOBs a device int32[B], equal their
    plain version on the card exactly and the one-block kernels row by row
    (in the one-block types)."""
    from tpubz_torch.kernels import suffix_sort

    data, n = _batch_rows(B, cuda)
    _, last = suffix_sort.bwt_forward_batch(data, n)
    ranks, used = mtf.mtf_ranks_batch(last, n)
    eob = used.sum(1, dtype=torch.int32) + 1
    before = rle2.BATCH_LAUNCHES
    got = rle2.rle2_encode_batch(ranks, n, eob)
    torch.cuda.synchronize()
    assert rle2.BATCH_LAUNCHES == before + 1
    for g, w in zip(got, rle2.rle2_encode_batch_ref(ranks, n, eob)):
        assert g.dtype == w.dtype and torch.equal(g.long(), w.long())
    for b, nb in enumerate(n):
        syms, length, freqs = rle2.rle2_encode(ranks[b].contiguous(), nb, eob[b])
        assert torch.equal(got[0][b].long(), syms.long()) and int(got[1][b]) == int(length)
        assert torch.equal(got[2][b].long(), freqs)


@pytest.mark.parametrize("B", list(_BATCHES))
def test_stage_compact_on_card(cuda, B):
    """The compact kernel equals its plain version on the card on the
    batched RLE2 rows (the overflow row's count past HI_CAP) and on random
    symbol rows with many symbols >= 256."""
    from tpubz_torch.kernels import compact, suffix_sort

    data, n = _batch_rows(B, cuda)
    _, last = suffix_sort.bwt_forward_batch(data, n)
    ranks, used = mtf.mtf_ranks_batch(last, n)
    syms, rle2_len, _ = rle2.rle2_encode_batch(ranks, n, used.sum(1, dtype=torch.int32) + 1)
    rng = np.random.default_rng(B)
    rand = torch.from_numpy(rng.choice([0, 3, 256, 257], size=(B, 900_104)).astype(np.uint16))
    lens = torch.from_numpy(rng.integers(1, 900_104, B).astype(np.int32))
    for s, ln in ((syms, rle2_len), (rand.to(cuda), lens.to(cuda))):
        before = compact.LAUNCHES
        got = compact.stage_compact(s, ln)
        torch.cuda.synchronize()
        assert compact.LAUNCHES == before + 1
        for g, w in zip(got, compact.stage_compact_ref(s, ln)):
            assert g.dtype == w.dtype and torch.equal(g.long(), w.long())
    if "overflow" in _BATCHES[B]:
        assert int(got[2].max()) > compact.HI_CAP


def test_sharded_transform_on_card_matches_cpu(cuda):
    """make_sharded_transform on the card gives the eight outputs of its
    CPU version on level-1 rows (an overflow row, a pad row)."""
    from tpubz_torch.corpus import sidecar_overflow_block
    from tpubz_torch.dist.sharded import make_sharded_transform

    rows = [sidecar_overflow_block(100_000), b"abc" * 3001, b"\x00",
            bytes(np.random.default_rng(3).integers(0, 256, 77_777, dtype=np.uint8))]
    data = torch.zeros(4, 100_096, dtype=torch.uint8)
    for b, r in enumerate(rows):
        data[b, : len(r)] = torch.frombuffer(bytearray(r), dtype=torch.uint8)
    n = [len(r) for r in rows]
    got = make_sharded_transform("cuda", 100_096)(data, n)
    want = make_sharded_transform("cpu", 100_096)(data, n)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.long().cpu(), w.long())


def test_compress_multihost_one_process_on_card(cuda):
    """compress_multihost in one process on the card gives compress's
    device-only stream and compress_cpu's, through every batched kernel,
    and decompress_multihost reads it back."""
    from tpubz_torch.corpus import sidecar_overflow_block
    from tpubz_torch.dist.multihost import compress_multihost, decompress_multihost
    from tpubz_torch.kernels import compact, suffix_sort

    d = mixed_corpus(1, 4)[:600_000] + sidecar_overflow_block(300_000) + b"xy" * 5000
    before = (suffix_sort.BATCH_LAUNCHES, mtf.BATCH_LAUNCHES, rle2.BATCH_LAUNCHES,
              compact.LAUNCHES)
    got = compress_multihost(d, 1, device="cuda")
    after = (suffix_sort.BATCH_LAUNCHES, mtf.BATCH_LAUNCHES, rle2.BATCH_LAUNCHES,
             compact.LAUNCHES)
    assert all(a - b >= 9 for a, b in zip(after, before))
    assert got == tpubz_torch.compress(d, 1, device="cuda") == compress_cpu(d, 1)
    assert decompress_multihost(got) == d


_DEVREFINE_BLOCKS = ["corpus_block0", "near_periodic", "one_byte_run", "all256", "overflow"]


def _level9_transform(name, enc):
    """The one-block transform on the card of a level-9 block: the corpus's
    first 900,000 bytes, an edge block or the sidecar overflow block."""
    from tpubz_torch.corpus import sidecar_overflow_block

    if name == "corpus_block0":
        blk = mixed_corpus(1, 2026)[:900_000]
    elif name == "overflow":
        blk = sidecar_overflow_block()
    else:
        blk = edge_blocks()[name]
    return enc.transform(np.frombuffer(blk, np.uint8))


@pytest.mark.parametrize("name", _DEVREFINE_BLOCKS)
def test_devrefine_kernels_match_plain_level9(cuda, name):
    """On a level-9 block's transform: chunk_hist, refine_pass over the
    symbols (uint16 with the device length, int32 with a host int) for every
    table count and with two equal tables, and pack_payload on the final
    tables equal their plain versions on the card, whole arrays; each call
    counts one launch, and pack_payload's total is the refinement's."""
    from tpubz_torch.block.encode import payload_tables
    from tpubz_torch.hostref.huffman import c_init_tables, canonical_codes
    from tpubz_torch.kernels import bitpack, huffman_dev as H

    enc = DeviceBlockEncoder(9)
    out = _level9_transform(name, enc)
    _, syms, rl_d, freqs_d, used_d = out
    freqs, used = freqs_d.cpu().numpy(), used_d.cpu().numpy()
    alpha, rl = int(used.sum()) + 2, int(rl_d)
    before = H.HIST_LAUNCHES
    hist = H.chunk_hist(syms, rl_d)
    torch.cuda.synchronize()
    assert H.HIST_LAUNCHES == before + 1
    assert torch.equal(hist, H.chunk_hist_ref(syms, rl_d))
    for tc in range(2, 7):
        lens = c_init_tables(freqs, tc, alpha).astype(np.int32)
        if tc == 6:
            lens[5] = lens[1]
        lens = torch.from_numpy(lens).to(cuda)
        want = H.refine_pass_ref(syms, rl_d, lens, tc)
        for s_, length in ((syms, rl_d), (syms.int(), rl)):
            before = H.REFINE_LAUNCHES
            got = H.refine_pass(s_, length, lens, tc)
            torch.cuda.synchronize()
            assert H.REFINE_LAUNCHES == before + 1
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)
    sel, lens, rfreq, tc, passes = enc.devrefine_tables(syms, rl_d, rl, freqs, alpha)
    codes = np.stack([canonical_codes(lens[t, :alpha]) for t in range(tc)])
    args = (syms, rl_d, *payload_tables(sel, codes, lens, tc, alpha, syms.shape[0], cuda))
    before = (H.PAYLOAD_LAUNCHES, bitpack.LAUNCHES)
    words, total = H.pack_payload(*args)
    torch.cuda.synchronize()
    assert (H.PAYLOAD_LAUNCHES, bitpack.LAUNCHES) == (before[0] + 1, before[1] + 1)
    rwords, rtotal = H.pack_payload_ref(*args)
    assert torch.equal(words, rwords) and int(total) == int(rtotal)
    assert int(total) == int((rfreq[:tc, :alpha] * lens[:tc, :alpha]).sum()) and passes >= 4


@pytest.mark.parametrize("out_len", [1, 49, 50, 51, 799, 800, 801, 12_799, 12_800, 12_801,
                                     900_104])
def test_refine_pass_on_card_tile_edges(cuda, out_len):
    """refine_pass over seeded symbols (RUNA/RUNB runs, 256 and 257, a block
    of one hot bin) at the edges of a group, a warp's 800-symbol tile and a
    CTA's 12,800, for stream lengths of 1, a partial group and all lanes,
    equals its plain version; two calls on the shared scratch in a row
    (tables with stale rows, then zero rows past the count) stay equal,
    so each call leaves the scratch zeroed."""
    from tpubz_torch.kernels import huffman_dev as H

    rng = np.random.default_rng(out_len)
    s = rng.integers(0, 258, out_len)
    s[rng.random(out_len) < 0.5] = rng.integers(0, 2)
    s[: out_len // 3] = 1  # a hot bin
    syms = torch.from_numpy(s.astype(np.uint16)).to(cuda)
    for rl in sorted({1, max(1, out_len - 7), out_len}):
        for tc, stale in ((3, 15), (6, 0), (2, 0)):
            lens = rng.integers(1, 18, (6, 258)).astype(np.int32)
            lens[tc:] = stale
            lens = torch.from_numpy(lens).to(cuda)
            got = H.refine_pass(syms, torch.tensor(rl, device=cuda), lens, tc)
            want = H.refine_pass_ref(syms, rl, lens, tc)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (rl, tc)
    assert not any(int(t.abs().sum()) for t in H._scratch.values())


def test_refine_pass_is_one_launch_on_card(cuda):
    """One refinement pass is one kernel on the card (no memset, no copy),
    by torch.profiler; a block's RefinePasses allocates once and each pass
    equals the plain version."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpubz_torch.hostref.huffman import c_init_tables
    from tpubz_torch.kernels import huffman_dev as H

    enc = DeviceBlockEncoder(9)
    _, syms, rl_d, freqs_d, used_d = _level9_transform("corpus_block0", enc)
    freqs, used = freqs_d.cpu().numpy(), used_d.cpu().numpy()
    alpha, rl = int(used.sum()) + 2, int(rl_d)
    lens = torch.from_numpy(c_init_tables(freqs, 6, alpha).astype(np.int32)).to(cuda)
    H.refine_pass(syms, rl_d, lens, 6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        H.refine_pass(syms, rl_d, lens, 6)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "refine_symbols" in names[0], names
    passes = H.RefinePasses(syms, rl_d)
    nsel = H.nsel_cap(rl)
    for tc in (6, 4):
        table = c_init_tables(freqs, tc, alpha)
        sel, rfreq = passes.run(table, tc, nsel)
        wsel, wrfreq = H.refine_pass_ref(syms, rl_d, torch.from_numpy(table.astype(np.int32)), tc)
        assert np.array_equal(sel, wsel.cpu().numpy()[:nsel])
        assert np.array_equal(rfreq, wrfreq.cpu().numpy())
    assert not passes.scratch.any() and set(passes.host_us) == {"upload", "launch", "fetch"}


@pytest.mark.parametrize("B", list(_BATCHES))
def test_refine_pass_on_card_batch_rows(cuda, B):
    """refine_pass on each row of the batched transform (a uint16 view at
    the row's offset into [B, OUT], its int32 length a 0-d view) equals its
    plain version."""
    from tpubz_torch.dist.sharded import make_sharded_transform
    from tpubz_torch.kernels import huffman_dev as H

    data, n = _batch_rows(B, cuda)
    _, syms, rle2_len = make_sharded_transform(cuda, 900_096)(data, n)[:3]
    rng = np.random.default_rng(B)
    lens = torch.from_numpy(rng.integers(1, 18, (6, 258)).astype(np.int32)).to(cuda)
    for b in range(B):
        got = H.refine_pass(syms[b], rle2_len[b], lens, 5)
        want = H.refine_pass_ref(syms[b], rle2_len[b], lens, 5)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), b


@pytest.mark.parametrize("B", list(_BATCHES))
def test_chunk_hist_batch_on_card(cuda, B):
    """The batched histogram of the batched transform's rows equals its
    plain version and the one-block kernel row by row."""
    from tpubz_torch.dist.sharded import make_sharded_transform
    from tpubz_torch.kernels import huffman_dev as H

    data, n = _batch_rows(B, cuda)
    _, syms, rle2_len = make_sharded_transform(cuda, 900_096)(data, n)[:3]
    before = H.HIST_BATCH_LAUNCHES
    hist = H.chunk_hist_batch(syms, rle2_len)
    torch.cuda.synchronize()
    assert H.HIST_BATCH_LAUNCHES == before + 1
    assert torch.equal(hist, H.chunk_hist_batch_ref(syms, rle2_len))
    for b in range(B):
        assert torch.equal(hist[b], H.chunk_hist(syms[b], rle2_len[b]))


@pytest.mark.parametrize("m", [1, 4095, 4096, 4097, 1 << 20])
def test_pack_bits_on_card_matches_plain(cuda, m):
    """Fields of 0 to 24 bits (zero-length ones, all-ones 24-bit ones, ones
    that cross a word) across tile edges: words and total equal the plain
    version's; with too few words the fields past them are dropped."""
    from tpubz_torch.kernels import bitpack

    rng = np.random.default_rng(m)
    bits = rng.integers(0, 25, m).astype(np.int32)
    bits[3::11] = 24
    vals = (rng.integers(0, 1 << 24, m) & ((1 << bits) - 1)).astype(np.uint32)
    vals[bits == 24] = (1 << 24) - 1
    v = torch.from_numpy(vals.view(np.int32)).to(cuda)
    b = torch.from_numpy(bits).to(cuda)
    for cap in ((int(bits.sum()) + 31) // 32 + 1, max(1, int(bits.sum()) // 64)):
        words, total = bitpack.pack_bits_device(v, b, cap)
        rwords, rtotal = bitpack.pack_bits_device_ref(v, b, cap)
        torch.cuda.synchronize()
        assert torch.equal(words, rwords) and int(total) == int(rtotal) == int(bits.sum())


@pytest.mark.parametrize("name", _DEVREFINE_BLOCKS)
def test_encode_block_devrefine_on_card_matches_emit_block(cuda, name):
    """encode_block_devrefine on the card gives emit_block's bytes for the
    fetched block, through the kernels and none of their plain versions."""
    from tpubz_torch.kernels import huffman_dev as H

    enc = DeviceBlockEncoder(9)
    out = _level9_transform(name, enc)
    before = (H.HIST_LAUNCHES, H.REFINE_LAUNCHES, H.PAYLOAD_LAUNCHES)
    got = enc.encode_block_devrefine(out, 0x9ABCDEF0).pack()
    assert got == enc.emit_block(*enc.fetch(out), 0x9ABCDEF0).pack()
    after = (H.HIST_LAUNCHES, H.REFINE_LAUNCHES, H.PAYLOAD_LAUNCHES)
    assert after[0] == before[0] and after[1] >= before[1] + 4  # no histogram: the symbols
    assert after[2] == before[2] + 1


def test_devrefine_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from tpubz_torch.kernels import bitpack, huffman_dev as H

    syms = torch.zeros(1000, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        H.chunk_hist(syms.to(torch.int64), 10)
    with pytest.raises(TypeError):
        H.chunk_hist(syms, torch.tensor(10.0, device=cuda))
    with pytest.raises(ValueError):
        H.chunk_hist_batch(syms.view(1, -1), torch.tensor([1, 2], device=cuda))
    with pytest.raises(TypeError):
        bitpack.pack_bits_device(syms.to(torch.int64), syms.to(torch.int64), 10)
    lens = torch.ones(6, 258, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        H.refine_pass(syms, 10, lens.cpu(), 6)  # the lengths on another device
    with pytest.raises(ValueError):
        H.refine_pass(syms, 10, lens, 7)
    with pytest.raises(TypeError):
        H.refine_pass(syms.to(torch.int64), 10, lens, 6)
    with pytest.raises(TypeError):
        H.refine_pass(syms, torch.tensor(10.0, device=cuda), lens, 6)
    with pytest.raises(ValueError):
        H.RefinePasses(syms, 10).launch(1)


_LEAN_SOURCES = {
    "corpus_block0": lambda: mixed_corpus(1, 2026)[:900_000],
    "near_periodic": lambda: edge_blocks()["near_periodic"],
    "one_byte_run": lambda: edge_blocks()["one_byte_run"],
    "all256": lambda: edge_blocks()["all256"],
    "overflow": sidecar_overflow_block,
}


@pytest.mark.parametrize("name", list(_LEAN_SOURCES))
def test_rle2_compact_on_card_matches_plain_level9(cuda, name):
    """rle2_compact on the card equals its plain version on a level-9
    block's MTF ranks, every output whole (the overflow block's count past
    HI_CAP, all256's EOB 257), and counts one launch; the lean fetch equals
    the int16 fetch of the same block field by field."""
    from tpubz_torch.kernels import compact

    enc = DeviceBlockEncoder(9)
    blk = np.frombuffer(_LEAN_SOURCES[name](), np.uint8)
    last = enc.transform_bwt(blk)[1]
    ranks, used = mtf.mtf_ranks(last, blk.size)
    before = compact.LEAN_LAUNCHES
    got = compact.rle2_compact(ranks, blk.size, used)
    torch.cuda.synchronize()
    assert compact.LEAN_LAUNCHES == before + 1
    for g, w in zip(got, compact.rle2_compact_ref(ranks, blk.size, used)):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g.long(), w.long())
    if name == "overflow":
        assert int(got[3]) > compact.HI_CAP
    a, b = enc.fetch(enc.transform(blk)), enc.fetch(enc.transform(blk, lean=True))
    assert a[0] == b[0] and a[2] == b[2] and a[1].dtype == b[1].dtype
    assert all(np.array_equal(x, y) for x, y in zip((a[1], a[3], a[4]), (b[1], b[3], b[4])))


def test_rle2_compact_on_card_random_runs(cuda):
    """rle2_compact on random ranks with zero runs up to 70,000 long, rank
    255 and all 256 bytes used (EOB 257), at odd lengths, equals its plain
    version."""
    from tpubz_torch.kernels import compact

    rng = np.random.default_rng(10)
    for N, n in ((900_096, 899_999), (4096, 4096), (8192, 1), (8192, 0)):
        r = np.zeros(N, np.int32)
        at = int(rng.integers(0, 50))
        while at < N:
            r[at] = rng.integers(1, 256)
            at += 1 + int(rng.choice([0, 1, 3, 30, 700, 5000, 70_000]))
        r[: min(N, 300): 2] = 255
        ranks = torch.from_numpy(r).to(cuda)
        used = torch.ones(256, dtype=torch.bool, device=cuda)
        for g, w in zip(compact.rle2_compact(ranks, n, used),
                        compact.rle2_compact_ref(ranks, n, used)):
            assert torch.equal(g.long(), w.long()), (N, n)


def test_encode_block_lean_on_card_matches_native(cuda, tpubz_native):
    """encode_block (the lean chain) on the card gives the bits of the
    block as tpubz's native engine transforms it, for level-9 blocks, the
    overflow block included."""
    enc = DeviceBlockEncoder(9)
    for name in ("corpus_block0", "all256", "overflow"):
        blk = np.frombuffer(_LEAN_SOURCES[name](), np.uint8)
        key, syms, freqs, used = tpubz_native.block_transform_native(blk)
        want = enc.emit_block(int(key), syms, syms.size, freqs.astype(np.int64), used, 0x1234)
        assert enc.encode_block(blk, 0x1234).pack() == want.pack(), name


def _cycle(key, last, n):
    """The length of p_0's cycle of the next pointers, on the host."""
    from tpubz_torch.kernels import ibwt

    nxt = ibwt.next_pointers_ref(last.cpu(), n).numpy()
    p = start = int(nxt[key])
    length = 0
    while True:
        p, length = int(nxt[p]), length + 1
        if p == start:
            return length


def _check_inverse_record(rec, key, last, n):
    """A finished inverse's record, as the card counted it: the orbit's
    four kernels, L equal to p_0's cycle, segments of p_0's cycle among
    the level-1 walks, the longest walk at least the mean segment."""
    from tpubz_torch.kernels import ibwt

    orbit = _cycle(key, last, n)
    assert rec["n"] == n and rec["launches"] == ibwt.sizes()["orbit_kernels"] == 4
    assert rec["orbit"] == orbit and 1 <= rec["segments"] <= rec["splitters"]
    assert rec["longest"] * rec["segments"] >= orbit
    assert rec["list_splitters"] >= 1 and rec["top_splitters"] >= 1


@pytest.mark.parametrize("name", ["corpus_block0", "near_periodic", "one_byte_run", "all256"])
def test_ibwt_kernels_on_card_level9(cuda, name):
    """next_pointers and bwt_inverse_device on the card equal their plain
    versions on a level-9 block's BWT, and the inverse gives the block
    back; each call counts its launches, and the inverse's record (read
    after the call, counted on the card) holds the orbit and its walks."""
    from tpubz_torch.kernels import ibwt

    last, n = _level9_last(name, cuda)
    blk = mixed_corpus(1, 2026)[:900_000] if name == "corpus_block0" else edge_blocks()[name]
    data = torch.zeros(900_096, dtype=torch.uint8, device=cuda)
    data[:n] = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(cuda)
    key = int(bwt_forward(data, n)[0])
    ibwt.finish_calls()
    before = (ibwt.NEXT_LAUNCHES, ibwt.INVERSE_LAUNCHES, ibwt.KERNEL_LAUNCHES)
    nxt = ibwt.next_pointers(last, n)
    out = ibwt.bwt_inverse_device(key, last, n)
    (rec,) = ibwt.finish_calls()
    assert (ibwt.NEXT_LAUNCHES, ibwt.INVERSE_LAUNCHES, ibwt.KERNEL_LAUNCHES) == (
        before[0] + 2, before[1] + 1, before[2] + 4)
    assert torch.equal(nxt, ibwt.next_pointers_ref(last, n))
    assert bytes(out.cpu().numpy()) == blk
    assert torch.equal(out, ibwt.bwt_inverse_device_ref(key, last, n))
    _check_inverse_record(rec, key, last, n)
    assert (rec["orbit"] < n) == (name in ("one_byte_run", "all256"))


def _small_blocks():
    rng = np.random.default_rng(7)
    blocks = {f"random3_{n}": rng.integers(0, 3, n, dtype=np.uint8).tobytes()
              for n in (0, 1, 2, 3, 4095, 4096, 4097, 100_000)}
    blocks.update({
        "abc_333": b"abc" * 333,  # 333 cycles of 3
        "period_256": bytes(range(256)) * 64,  # a period past the fill's 16-byte words
        "period_16385": bytes(rng.integers(0, 256, 16_385, dtype=np.uint8)) * 3,
        "run_5000": b"a" * 5000,  # every row a fixed point
        "max_n": rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),  # positions of 20 bits
    })
    return blocks


@pytest.mark.parametrize("name", list(_small_blocks()))
def test_ibwt_kernels_on_card_small(cuda, name):
    """The inverse kernels at small and tile-edge lengths with pad lanes
    past n (N = n + 100), periodic blocks (L < n: the fill from shared
    memory and, past 16,384, from the output), a run block and n = 2^20:
    pointers equal to the plain version, the block given back, the record
    held; the calls count their kernels only for n > 0."""
    from tpubz_torch.kernels import ibwt

    blk = _small_blocks()[name]
    n = len(blk)
    data = torch.zeros(n + 100, dtype=torch.uint8, device=cuda)
    if n:
        data[:n] = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(cuda)
    key, last = bwt_forward(data, n)
    ibwt.finish_calls()
    before = (ibwt.NEXT_LAUNCHES, ibwt.INVERSE_LAUNCHES)
    assert torch.equal(ibwt.next_pointers(last, n), ibwt.next_pointers_ref(last, n))
    assert bytes(ibwt.bwt_inverse_device(int(key), last, n).cpu().numpy()) == blk
    ran = int(n > 0)
    assert (ibwt.NEXT_LAUNCHES, ibwt.INVERSE_LAUNCHES) == (before[0] + 2 * ran, before[1] + ran)
    records = ibwt.finish_calls()
    assert len(records) == ran
    if ran:
        _check_inverse_record(records[0], int(key), last, n)


def test_ibwt_inverse_calls_in_flight_on_card(cuda):
    """Twenty inverse calls enqueued back to back with no wait between
    them: every output equal to its block, and their records read in call
    order afterwards."""
    from tpubz_torch.kernels import ibwt

    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 1 + k, 50_000 + 997 * k, dtype=np.uint8).tobytes()
              for k in range(20)]
    cols = []
    for blk in blocks:
        data = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(cuda)
        key, last = bwt_forward(data, len(blk))
        cols.append((int(key), last))
    ibwt.finish_calls()
    outs = [ibwt.bwt_inverse_device(key, last, last.shape[0]) for key, last in cols]
    records = ibwt.finish_calls()
    assert [r["n"] for r in records] == [len(b) for b in blocks]
    assert all(bytes(o.cpu().numpy()) == b for o, b in zip(outs, blocks))
    assert ibwt.sizes()["log_d"] == ibwt.LOG_D


def test_lean_and_ibwt_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from tpubz_torch.kernels import compact, ibwt

    ranks = torch.zeros(4096, dtype=torch.int32, device=cuda)
    used = torch.zeros(256, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        compact.rle2_compact(ranks, 10, used.int())
    with pytest.raises(TypeError):
        compact.rle2_compact(ranks.long(), 10, used)
    with pytest.raises(ValueError):
        compact.rle2_compact(ranks, 5000, used)
    last = torch.zeros(100, dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        ibwt.next_pointers(last.int(), 10)
    with pytest.raises(ValueError):
        ibwt.bwt_inverse_device(10, last, 10)
    with pytest.raises(ValueError):
        ibwt.next_pointers(torch.zeros((1 << 20) + 1, dtype=torch.uint8, device=cuda), (1 << 20) + 1)


# The packing kernel (csrc/bitpack.cu) and the compact form (csrc/compact.cu):
# one launch a call and no memset, on the stream's look-back scratch
# (kernels/look_back.py).


def _garbage_cache(cuda):
    """Leave 64 MB of 0xFF bytes in the allocator's cache, so that the next
    outputs start as garbage: a word or entry the kernel forgets shows."""
    junk = torch.full((1 << 24,), -1, dtype=torch.int32, device=cuda)
    del junk


def _at_offset(arr, offset, cuda):
    """A device view of the numpy array at element `offset` of a larger one."""
    flat = np.zeros(arr.size + offset + 5, arr.dtype)
    flat[offset: offset + arr.size] = arr.ravel()
    return torch.from_numpy(flat).to(cuda)[offset: offset + arr.size].view(arr.shape)


def _pack_fields(m, seed, zero_tile=None):
    """m seeded fields of 0 to 24 bits (every 11th 24 bits, all ones), and
    optionally tile `zero_tile`'s 4096 all of 0 bits: (vals int32, bits)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 25, m).astype(np.int32)
    bits[3::11] = 24
    if zero_tile is not None:
        bits[zero_tile * 4096: (zero_tile + 1) * 4096] = 0
    vals = (rng.integers(0, 1 << 24, m) & ((1 << bits) - 1)).astype(np.uint32)
    vals[bits == 24] = (1 << 24) - 1
    return vals.view(np.int32), bits


def _payload_case(out, seed):
    """Seeded symbols < 258 (RUNA/RUNB runs), selectors and 6 x 258 tables
    of 1 to 17 bits: (syms int64 numpy, sel int8, codes int32, lens int32)."""
    from tpubz_torch.kernels import huffman_dev as H

    rng = np.random.default_rng(seed)
    s = rng.integers(0, 258, out)
    s[rng.random(out) < 0.5] = rng.integers(0, 2)
    lens = rng.integers(1, 18, (6, 258)).astype(np.int32)
    codes = (rng.integers(0, 1 << 17, (6, 258)) & ((1 << lens) - 1)).astype(np.int32)
    sel = rng.integers(0, 6, H.nsel_cap(out)).astype(np.int8)
    return s, sel, codes, lens


def _equal(got, want):
    return all(g.dtype == w.dtype and torch.equal(g.long(), w.long()) for g, w in zip(got, want))


@pytest.mark.parametrize("m", [1, 15, 4095, 4096, 4097, 12_289])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 0), (3, 2), (2, 1)],
                         ids=["aligned", "vals+1", "vals+3_bits+2", "vals+2_bits+1"])
def test_pack_bits_on_card_edge_shapes(cuda, m, offsets):
    """Fields at and around the tile edges (one field, a partial tile, a
    tile, a tile and one, a tile of only 0-bit fields between two others),
    the values and the lengths views at odd element offsets (their own
    alignments), into fewer words than the stream (fields dropped), one
    more word, and words past every tile's lanes: the plain version's words
    and total, on outputs that start as garbage."""
    from tpubz_torch.kernels import bitpack

    vals, bits = _pack_fields(m, m, zero_tile=1 if m > 8192 else None)
    v, b = _at_offset(vals, offsets[0], cuda), _at_offset(bits, offsets[1], cuda)
    need = (int(bits.sum()) + 31) // 32
    for cap in (max(1, need // 3), need + 1, (m // 4096 + 2) * 4096 + 4099):
        _garbage_cache(cuda)
        got = bitpack.pack_bits_device(v, b, cap)
        assert _equal(got, bitpack.pack_bits_device_ref(v, b, cap)), cap


@pytest.mark.parametrize("rle2_len", [0, 1, 1023, 1024, 1025, 4095, 4096, 4097, 20_008])
@pytest.mark.parametrize("sym_dtype", [np.int32, np.uint16], ids=["i32", "u16"])
@pytest.mark.parametrize("offset", [0, 1, 5])
def test_pack_payload_on_card_edge_lengths(cuda, rle2_len, sym_dtype, offset):
    """Stream lengths of 0, 1, around 1024 and around a tile (4096), and
    every lane; int32 and
    uint16 symbols, a view at an odd element offset; the length a host int
    and a device int64 and int32 scalar: the plain version's words and
    total."""
    from tpubz_torch.kernels import huffman_dev as H

    out = 20_008
    s, sel, codes, lens = _payload_case(out, rle2_len + offset)
    syms = _at_offset(s.astype(sym_dtype), offset, cuda)
    tables = [torch.from_numpy(a).to(cuda) for a in (sel, codes, lens)]
    for length in (rle2_len, torch.tensor(rle2_len, device=cuda),
                   torch.tensor(rle2_len, dtype=torch.int32, device=cuda)):
        _garbage_cache(cuda)
        got = H.pack_payload(syms, length, *tables)
        assert _equal(got, H.pack_payload_ref(syms, length, *tables)), length


def test_pack_payload_out_of_table_lanes_are_empty_fields(cuda):
    """A symbol >= 258 or a selector outside 0..5 in the stream gives a
    field of 0 bits (no shift by 32, no read past the tables)."""
    from tpubz_torch.kernels import bitpack, huffman_dev as H

    out = 9_000
    s, sel, codes, lens = _payload_case(out, 7)
    s[5::97] = 258 + s[5::97] % 40
    sel[3::7] = 6
    sel[4::11] = -1
    valid = (s < 258) & np.isin(sel[np.arange(out) // 50], range(6))
    t = np.clip(sel[np.arange(out) // 50], 0, 5)
    v = np.where(valid, codes[t, np.minimum(s, 257)], 0).astype(np.int32)
    b = np.where(valid, lens[t, np.minimum(s, 257)], 0).astype(np.int32)
    want = bitpack.pack_bits_device_ref(torch.from_numpy(v), torch.from_numpy(b),
                                        H.payload_words_cap(out))
    got = H.pack_payload(torch.from_numpy(s.astype(np.uint16)).to(cuda), out,
                         *(torch.from_numpy(a).to(cuda) for a in (sel, codes, lens)))
    assert _equal([g.cpu() for g in got], want)


@pytest.mark.parametrize("OUT", [1, 15, 4096, 4103, 900_104])
@pytest.mark.parametrize("offset", [0, 1, 7])
def test_stage_compact_on_card_shapes_and_views(cuda, OUT, offset):
    """Five rows (odd rows of syms_u8 off a 16-byte boundary when OUT is
    not a multiple of 16), the rows a view at an odd element offset, rows
    of stream length 0, 1, half, all and past the row (and a negative one),
    and a row whose symbols >= 256 overflow the sidecar: the plain
    version's bytes, sidecars and counts, on outputs that start as
    garbage."""
    from tpubz_torch.kernels import compact

    B = 5
    rng = np.random.default_rng(OUT + offset)
    s = rng.choice([0, 1, 3, 255, 256, 257, 300], size=(B, OUT),
                   p=[0.3, 0.2, 0.2, 0.1, 0.1, 0.05, 0.05]).astype(np.uint16)
    lens = np.array([0, 1, OUT // 2, OUT, OUT + 5], np.int32)
    if OUT < 10:
        lens[0] = -3
    syms = _at_offset(s, offset, cuda)
    rl = torch.from_numpy(lens).to(cuda)
    _garbage_cache(cuda)
    got = compact.stage_compact(syms, rl)
    want = compact.stage_compact_ref(syms, rl)
    assert _equal(got, want)
    if OUT == 900_104:
        assert int(got[2].max()) > compact.HI_CAP


def _three_calls(cuda):
    """A pack_bits, a pack_payload and a stage_compact call of seeded sizes
    on the current stream, with their plain versions: [(run, plain)]."""
    from tpubz_torch.kernels import bitpack, compact, huffman_dev as H

    vals, bits = _pack_fields(70_001, 3)
    v, b = torch.from_numpy(vals).to(cuda), torch.from_numpy(bits).to(cuda)
    cap = (int(bits.sum()) + 31) // 32 + 1
    s, sel, codes, lens = _payload_case(50_000, 4)
    syms = torch.from_numpy(s.astype(np.uint16)).to(cuda)
    tables = [torch.from_numpy(a).to(cuda) for a in (sel, codes, lens)]
    rows = torch.from_numpy(np.random.default_rng(5).choice(
        [0, 2, 256, 257], size=(3, 30_008)).astype(np.uint16)).to(cuda)
    rl = torch.tensor([30_008, 9, 17_000], dtype=torch.int32, device=cuda)
    return [
        (lambda: bitpack.pack_bits_device(v, b, cap), lambda: bitpack.pack_bits_device_ref(v, b, cap)),
        (lambda: bitpack.pack_bits_device(v[:5000], b[:5000], 900),
         lambda: bitpack.pack_bits_device_ref(v[:5000], b[:5000], 900)),
        (lambda: H.pack_payload(syms, 40_000, *tables),
         lambda: H.pack_payload_ref(syms, 40_000, *tables)),
        (lambda: compact.stage_compact(rows, rl), lambda: compact.stage_compact_ref(rows, rl)),
        (lambda: compact.stage_compact(rows[:1], rl[:1]),
         lambda: compact.stage_compact_ref(rows[:1], rl[:1])),
    ]


def test_pack_and_compact_back_to_back_and_on_two_streams(cuda):
    """Ten calls back to back on one stream with no wait between them
    (large, small and batched calls, so each meets words the one before
    used), then calls on two streams interleaved: every output equals the
    plain version's, and each stream has a scratch of its own."""
    from tpubz_torch.kernels import look_back

    calls = _three_calls(cuda)
    outs = [calls[k % len(calls)][0]() for k in range(10)]
    torch.cuda.synchronize()
    for k, got in enumerate(outs):
        assert _equal(got, calls[k % len(calls)][1]()), k
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for k in range(10):
        with torch.cuda.stream(streams[k % 2]):
            outs.append(calls[k % len(calls)][0]())
    torch.cuda.synchronize()
    for k, got in enumerate(outs):
        assert _equal(got, calls[k % len(calls)][1]()), k
    scratches = []
    for st in streams:
        with torch.cuda.stream(st):
            scratches.append(look_back.scratch_of(cuda))
    assert scratches[0] is not None and scratches[1] is not None
    assert scratches[0] is not scratches[1]


def test_look_back_scratch_across_an_epoch_wrap(cuda):
    """Calls across the epoch's wrap (kEpochMax back to 1) on one scratch,
    of alternating sizes: every output equals the plain version's."""
    from tpubz_torch.kernels import look_back

    calls = _three_calls(cuda)
    calls[0][0]()
    sc = look_back.scratch_of(cuda)
    sc.epoch = look_back.EPOCH_MAX - 3
    seen = []
    for k in range(8):
        run, plain = calls[k % len(calls)]
        got = run()
        seen.append(sc.epoch)
        assert _equal(got, plain()), k
    assert look_back.EPOCH_MAX in seen and 1 in seen
    assert look_back.scratch_of(cuda) is sc


@pytest.mark.parametrize("kernel", ["pack_bits", "pack_payload", "stage_compact"])
def test_pack_and_compact_are_one_launch_on_card(cuda, kernel):
    """One call is one kernel on the card (no memset, no copy), by
    torch.profiler, and counts one launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpubz_torch.kernels import bitpack, compact, huffman_dev as H

    run, _ = _three_calls(cuda)[{"pack_bits": 0, "pack_payload": 2, "stage_compact": 3}[kernel]]
    counter = (compact, "LAUNCHES") if kernel == "stage_compact" else (bitpack, "LAUNCHES")
    run()
    torch.cuda.synchronize()
    before = getattr(*counter), H.PAYLOAD_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    want = "compact_rows" if kernel == "stage_compact" else "pack_tiles"
    assert len(names) == 1 and want in names[0], names
    assert getattr(*counter) == before[0] + 1
    assert H.PAYLOAD_LAUNCHES == before[1] + (kernel == "pack_payload")


def test_pack_and_compact_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """The wrappers' refusals, and the library's: no epoch 0, no scratch
    smaller than the call's tiles, no words off a 16-byte boundary."""
    import ctypes

    from tpubz_torch.kernels import _build, bitpack, compact, huffman_dev as H

    v = torch.zeros(100, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        bitpack.pack_bits_device(v, v[:99], 10)
    with pytest.raises(TypeError):
        bitpack.pack_bits_device(v.cpu(), v, 10)
    with pytest.raises(ValueError):
        bitpack.pack_bits_device(v[:0], v[:0], 10)
    with pytest.raises(ValueError):
        bitpack.pack_bits_device(v, v, 0)
    tables = torch.zeros(6, 258, dtype=torch.int32, device=cuda)
    sel = torch.zeros(2, dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        H.pack_payload(v.long(), 10, sel, tables, tables)
    with pytest.raises(TypeError):
        H.pack_payload(v, 10, sel.int(), tables, tables)
    with pytest.raises(TypeError):
        H.pack_payload(v, torch.tensor(10.0, device=cuda), sel, tables, tables)
    rows = torch.zeros(2, 64, dtype=torch.uint16, device=cuda)
    lens = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        compact.stage_compact(rows.int(), lens)
    with pytest.raises(TypeError):
        compact.stage_compact(rows.t(), lens)
    with pytest.raises(TypeError):
        compact.stage_compact(rows, lens.long())
    with pytest.raises(ValueError):
        compact.stage_compact(rows[:0], lens[:0])
    lib = _build.load()
    scratch = torch.zeros(9, dtype=torch.int64, device=cuda)
    words = torch.zeros(16, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    P = ctypes.c_void_p

    def pack(epoch, capacity, at):
        return lib.tpubz_pack_bits_device(P(v.data_ptr()), P(v.data_ptr()), 100, 8,
                                          P(scratch.data_ptr()), capacity, epoch, 0,
                                          P(words[at:].data_ptr()), P(scratch.data_ptr()),
                                          P(stream))

    assert pack(0, 8, 0) != 0 and pack(1 << 26, 8, 0) != 0  # epochs 1..2^26 - 1
    assert pack(1, 0, 0) != 0  # a tile and no status word
    assert pack(1, 8, 1) != 0  # words off a 16-byte boundary
    torch.cuda.synchronize()

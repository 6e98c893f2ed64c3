"""The port on an NVIDIA GPU: the CUDA kernels against their plain versions,
the BWT on the card against the CPU path, and the device slice against
tpubz's native CPU engine, at levels 1 and 9.

Marked ``cuda``; each test skips unless torch sees a card (decided in the
fixture, never at import). The codec is integer, so every comparison is
exact: tolerance 0. On a machine with a card:
    python -m pytest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

import torch

from tpubz.format.constants import block_budget
from tpubz.hostref.rle1 import rle1_blocks
from tpubz.stream.api import compress_cpu

import tpubz_torch
from tpubz_torch.block.encode import DeviceBlockEncoder
from tpubz_torch.corpus import edge_blocks, mixed_corpus
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
        assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w)


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
        assert all(torch.equal(g, w) for g, w in zip(got, want))


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
    counted call, a radix sort per round run and no bitonic sort; small
    cases also equal the plain version on the CPU."""
    from tpubz_torch.kernels import bitonic, radix, suffix_sort

    c = _bwt_case(case)
    N = 900_096 if case.startswith("level9_") else 4352
    data = torch.zeros(N, dtype=torch.uint8)
    data[: len(c)] = torch.frombuffer(bytearray(c), dtype=torch.uint8)
    on_card = data.to(cuda)
    before = (suffix_sort.LAUNCHES, suffix_sort.ROUNDS_RUN, radix.SORTS, dict(bitonic.CALLS))
    key, last = bwt_forward(on_card, len(c))
    torch.cuda.synchronize()
    rounds = suffix_sort.ROUNDS_RUN - before[1]
    assert suffix_sort.LAUNCHES == before[0] + 1
    assert 1 <= rounds <= suffix_sort.call_sizes(len(c))[2]
    assert radix.SORTS == before[2] + rounds and bitonic.CALLS == before[3]
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
    """On a level-9 block's transform: chunk_hist, refine_pass for every
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
        before = H.REFINE_LAUNCHES
        got = H.refine_pass(hist, lens, tc)
        torch.cuda.synchronize()
        assert H.REFINE_LAUNCHES == before + 1
        for g, w in zip(got, H.refine_pass_ref(hist, lens, tc)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    sel, lens, rfreq, tc, passes = enc.devrefine_tables(hist, rl, freqs, alpha)
    codes = np.stack([canonical_codes(lens[t, :alpha]) for t in range(tc)])
    args = (syms, rl_d, *payload_tables(sel, codes, lens, tc, alpha, syms.shape[0], cuda))
    before = (H.PAYLOAD_LAUNCHES, bitpack.LAUNCHES)
    words, total = H.pack_payload(*args)
    torch.cuda.synchronize()
    assert (H.PAYLOAD_LAUNCHES, bitpack.LAUNCHES) == (before[0] + 1, before[1] + 1)
    rwords, rtotal = H.pack_payload_ref(*args)
    assert torch.equal(words, rwords) and int(total) == int(rtotal)
    assert int(total) == int((rfreq[:tc, :alpha] * lens[:tc, :alpha]).sum()) and passes >= 4


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
    assert after[0] == before[0] + 1 and after[1] >= before[1] + 4
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

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
from tpubz.native import block_transform_native
from tpubz.stream.api import compress_cpu

import tpubz_torch
from tpubz_torch.block.encode import DeviceBlockEncoder
from tpubz_torch.corpus import edge_blocks, mixed_corpus
from tpubz_torch.kernels import mtf, rle2
from tpubz_torch.kernels.suffix_sort import bwt_forward

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


def test_level9_blocks_match_native(cuda):
    """Every level-9 block: fetch(transform(blk)) on the card gives the key,
    symbols, frequencies and used map of tpubz.native.block_transform_native."""
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
    block (b"ab" * 449_000 + b"c"): long runs of equal keys."""
    from tpubz_torch.kernels import suffix_sort

    blk = edge_blocks()["near_periodic"]
    data = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(device)
    return suffix_sort.round_keys(suffix_sort.seed_rank(data), 3)


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
def test_bwt_forward_on_card_matches_cpu(cuda, case):
    """bwt_forward on the card (one library call: the BWT kernels around
    the bitonic sort) gives the key and last column of the plain version on
    the card, pad lanes zero, with one counted call, a 2op sort per round run
    and a 1op sort only where ties remain; small cases also equal the plain
    version on the CPU."""
    from tpubz_torch.kernels import bitonic, suffix_sort

    c = _bwt_case(case)
    N = 900_096 if case.startswith("level9_") else 4352
    data = torch.zeros(N, dtype=torch.uint8)
    data[: len(c)] = torch.frombuffer(bytearray(c), dtype=torch.uint8)
    on_card = data.to(cuda)
    calls, before = dict(bitonic.CALLS), (suffix_sort.LAUNCHES, suffix_sort.ROUNDS_RUN)
    key, last = bwt_forward(on_card, len(c))
    torch.cuda.synchronize()
    rounds = suffix_sort.ROUNDS_RUN - before[1]
    assert suffix_sort.LAUNCHES == before[0] + 1
    assert 1 <= rounds <= suffix_sort.call_sizes(len(c))[2]
    assert bitonic.CALLS["bitonic_2op"] == calls["bitonic_2op"] + rounds
    assert bitonic.CALLS["bitonic_1op"] == calls["bitonic_1op"] + (case in _BWT_TIED)
    assert key.device.type == "cuda" and key.dtype == torch.int64 and key.dim() == 0
    rkey, rlast = suffix_sort.bwt_forward_ref(on_card, len(c))
    assert int(key) == int(rkey) and torch.equal(last, rlast)
    assert not last[len(c):].any()
    if not case.startswith("level9_"):
        ckey, clast = suffix_sort.bwt_forward_ref(data, len(c))
        assert int(key) == int(ckey) and torch.equal(last.cpu(), clast)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 100, 1 << 10, 900_000, 1 << 20])
def test_bwt_call_sizes(cuda, n):
    """The library's sizes for a block of n bytes: the cap covers n
    (3 * 2^(cap-2) >= n, the round after stalls) and is the least that does,
    every round has a pinned word, and the scratch holds at least the keys,
    positions and ranks of P lanes."""
    from tpubz_torch.kernels import suffix_sort

    nbytes, words, cap = suffix_sort.call_sizes(n)
    assert 3 << (cap - 2) >= n and (cap == 2 or 3 << (cap - 3) < n)
    assert words >= cap
    assert nbytes > 16 * suffix_sort.padded_length(n)


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
    bytes that one encoder gives block by block."""
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


def test_fetch_bwt_pinned_copy_matches_sync(cuda):
    """fetch_bwt's non-blocking copy into pinned memory, waited on through
    its event on another thread, equals a synchronous .cpu() of the same
    tensors; so does fetch's."""
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

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
from tpubz_torch.kernels import mtf_dominance
from tpubz_torch.kernels.mtf import mtf_parts
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


def _random_parts(nc, seed, device):
    rng = np.random.default_rng(seed)
    arrs = (
        rng.integers(-1, 256, (nc, 256)),
        rng.integers(0, 257, (nc, 256)),
        rng.integers(0, 2_000_000, (nc, 256)),
        rng.integers(0, 2_000_000, (nc, 256)),
    )
    return [torch.from_numpy(a.astype(np.int32)).to(device) for a in arrs]


@pytest.mark.parametrize("nc", [1, 64, 3516])
def test_kernel_matches_plain_random(cuda, nc):
    """Seeded random parts, up to the level-9 shape (nc = 3516): the kernel
    equals ranks_from_parts_ref on the card, exactly, and counts a launch."""
    parts = _random_parts(nc, nc, cuda)
    before = mtf_dominance.LAUNCHES
    got = mtf_dominance.ranks_from_parts(*parts)
    torch.cuda.synchronize()
    assert mtf_dominance.LAUNCHES == before + 1
    assert torch.equal(got, mtf_dominance.ranks_from_parts_ref(*parts))


def test_kernel_matches_plain_real(cuda):
    """The real MTF parts of a level-9 block of mixed bytes."""
    rng = np.random.default_rng(5)
    blk = np.concatenate((
        rng.integers(0, 256, 300_000), rng.integers(0, 5, 300_000),
        np.frombuffer(b"banana" * 50_000, np.uint8),
    )).astype(np.uint8)
    enc = DeviceBlockEncoder(9, cuda)
    data = torch.zeros(enc.N, dtype=torch.uint8, device=cuda)
    data[: blk.size] = torch.from_numpy(blk).to(cuda)
    _, last = bwt_forward(data, blk.size)
    lprev, lnext, keyi, keyrow, _ = mtf_parts(last, blk.size)
    got = mtf_dominance.ranks_from_parts(lprev, lnext, keyi, keyrow)
    assert torch.equal(got, mtf_dominance.ranks_from_parts_ref(lprev, lnext, keyi, keyrow))


def test_wrapper_rejects_other_chunks(cuda):
    parts = _random_parts(4, 0, cuda)
    with pytest.raises(ValueError):
        mtf_dominance.ranks_from_parts(*(p[:, :128].contiguous() for p in parts[:3]), parts[3])
    with pytest.raises(ValueError):
        mtf_dominance.ranks_from_parts(parts[0].t().contiguous().t(), *parts[1:])


def test_device_stream_matches_compress_cpu(cuda):
    """Multi-block level-1 stream on the card equals the native CPU engine,
    every block on the device, and round-trips."""
    rng = np.random.default_rng(9)
    d = (
        bytes(rng.integers(0, 256, 150_000, dtype=np.uint8))
        + b"ab" * 100_000 + b"c"
        + bytes(range(256)) * 400
    )
    before = mtf_dominance.LAUNCHES
    got = tpubz_torch.compress(d, 1, device="cuda")
    blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
    assert blocks >= 4
    assert mtf_dominance.LAUNCHES - before >= blocks
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
    every block launched the kernel."""
    d = _level9_data()
    before = mtf_dominance.LAUNCHES
    got = tpubz_torch.compress(d, 9, device="cuda")
    blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
    assert blocks == 5
    assert mtf_dominance.LAUNCHES - before >= blocks
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


_BWT_CASES = {
    "banana": b"banana" * 30,
    "aaaa": b"aaaa" * 100,
    "n1": b"x",
    "n777": bytes(np.random.default_rng(777).integers(0, 20, 777, dtype=np.uint8)),
    "near_periodic": b"ab" * 500 + b"c",
    "all256": bytes(range(256)) * 4,
    "pow2": bytes(np.random.default_rng(2).integers(0, 3, 4096, dtype=np.uint8)),
}


@pytest.mark.parametrize("case", list(_BWT_CASES) + ["level9_corpus"])
def test_bwt_forward_on_card_matches_cpu(cuda, case):
    """bwt_forward on the card (bitonic kernels) gives the key and last
    column of the port's CPU path (the plain network), pad lanes zero, and
    launches at least one 2op round and the 1op last-column sort."""
    from tpubz_torch.kernels import bitonic

    c = mixed_corpus(1, 3)[:900_000] if case == "level9_corpus" else _BWT_CASES[case]
    N = 900_096 if case == "level9_corpus" else 4352
    data = torch.zeros(N, dtype=torch.uint8)
    data[: len(c)] = torch.frombuffer(bytearray(c), dtype=torch.uint8)
    calls = dict(bitonic.CALLS)
    key, last = bwt_forward(data.to(cuda), len(c))
    ckey, clast = bwt_forward(data, len(c))
    assert int(key) == int(ckey)
    assert torch.equal(last.cpu(), clast)
    if len(c) > 1:
        assert bitonic.CALLS["bitonic_2op"] > calls["bitonic_2op"]
        assert bitonic.CALLS["bitonic_1op"] == calls["bitonic_1op"] + 1


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
    from tpubz_torch.kernels import bitonic
    from tpubz_torch.stream.files import compress_file

    d = _level9_data()
    calls = bitonic.CALLS["bitonic_1op"]
    if route == "bwt":
        monkeypatch.setenv("TPUBZ_DEVICE_STAGE", "bwt")
        launches = mtf_dominance.LAUNCHES
        got = tpubz_torch.compress(d, 9, device="cuda")
        assert mtf_dominance.LAUNCHES == launches
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
    assert bitonic.CALLS["bitonic_1op"] - calls == st["dev_blocks"]
    assert got == compress_cpu(d, 9)

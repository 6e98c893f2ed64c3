"""The decomposition of the BWT's library call (csrc/bwt.cu), emulated in
numpy on the CPU with the kernels' index math, against tpubz's bwt_forward
and the port's plain version.

The CUDA kernels run only on the card. Here each kernel is run CTA by CTA
and thread by thread as its source writes it (the seed keys from six cyclic
bytes, the round keys with the shift reduced mod n, the tile counts, the
re-rank with every CTA adding up the counts before it, the per-round state
slots), with small tiles (16-64 lanes) so that classes cross many of them,
and the host's loop with its one-round-ahead schedule, round cap and both
last-column routes. The sort between the kernels is numpy's, with the order
of equal keys shuffled: the network's order on ties is not part of any
kernel's contract. Every comparison is exact: tolerance 0.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpubz.hostref.bwt import bwt_encode
from tpubz.kernels import suffix_sort as jsort
from tpubz_torch.kernels import suffix_sort
from tpubz_torch.kernels.suffix_sort import bwt_forward, bwt_forward_ref, padded_length

torch.set_num_threads(2)

N = 2304  # 9 chunks of 256: one jit shape for every case
PAD_KEY = np.iinfo(np.int64).max
MAX_LOG2 = 20
STATE_SLOTS = 24  # the emulated state record: one slot per round

_rng = np.random.default_rng(20261018)
_text = (b"the quick brown fox jumps over the lazy dog; " * 40
         + b"pack my box with five dozen liquor jugs. " * 20)


def _flipped(c: bytes, at: int) -> bytes:
    return c[:at] + bytes([c[at] ^ 1]) + c[at + 1:]


CASES = {
    "n1": b"x",
    "n2_same": b"zz",
    "n2": b"ba",
    "n3": b"aba",
    "n255": bytes(_rng.integers(0, 4, 255, dtype=np.uint8)),
    "n256": bytes(_rng.integers(0, 4, 256, dtype=np.uint8)),
    "n257": bytes(_rng.integers(0, 4, 257, dtype=np.uint8)),
    "n1023": bytes(_rng.integers(0, 3, 1023, dtype=np.uint8)),
    "n1024": bytes(_rng.integers(0, 3, 1024, dtype=np.uint8)),
    "n1025": bytes(_rng.integers(0, 3, 1025, dtype=np.uint8)),
    "n2047": bytes(_rng.integers(0, 2, 2047, dtype=np.uint8)),
    "n2048": bytes(_rng.integers(0, 2, 2048, dtype=np.uint8)),
    "n2049": bytes(_rng.integers(0, 2, 2049, dtype=np.uint8)),
    "run": b"r" * 2000,
    "period7": b"abcabca" * 200,
    "period64_flip": _flipped(bytes(_rng.integers(0, 256, 64, dtype=np.uint8)) * 30, 1000),
    "period257": bytes(_rng.integers(0, 5, 257, dtype=np.uint8)) * 8,
    "near_periodic": b"ab" * 1000 + b"c",
    "all256": bytes(range(256)) * 8,
    "random256": bytes(_rng.integers(0, 256, 1500, dtype=np.uint8)),
    "text": _text[:2200],
}
CASE_IDS = list(CASES)
PERIODIC = ["n2_same", "run", "period7", "period257", "all256"]

_jax_bwt = jax.jit(jsort.bwt_forward)


def _pad(c: bytes) -> np.ndarray:
    p = np.zeros(N, np.uint8)
    p[: len(c)] = np.frombuffer(c, np.uint8)
    return p


# ------------------------------------------------------------ the kernels


def _wrap(i, k, n):
    """(i + k) mod n for 0 <= i < n, 0 <= k < n, as the kernels write it."""
    assert 0 <= k < n
    j = i + k
    return np.where(j >= n, j - n, j)


def seed_keys(block, n, P):
    keys = np.full(P, PAD_KEY, np.int64)
    for i in range(n):
        packed, j = 0, i
        for q in range(6):
            packed = (packed << (16 if q == 3 else 8)) | int(block[j])
            j = 0 if j + 1 == n else j + 1
        keys[i] = packed
    return keys, np.arange(P, dtype=np.int32)


def round_keys(rank, n, P, k):
    keys = np.full(P, PAD_KEY, np.int64)
    i = np.arange(n)
    keys[:n] = (rank[:n].astype(np.int64) << 32) | rank[_wrap(i, k, n)].astype(np.int64)
    return keys, np.arange(P, dtype=np.int32)


def sort_2op(keys, payload, rng):
    """An ascending sort that leaves equal keys in an arbitrary order."""
    order = np.lexsort((rng.permutation(keys.size), keys))
    return keys[order], payload[order]


def _load_flags(skey, base, n, per):
    """load_flags: one thread's `per` lanes from base on."""
    f = np.zeros(per, np.int64)
    prev = skey[base - 1] if 0 < base <= n else 0
    for q in range(per):
        if base + q < n:
            f[q] = int(skey[base + q] != prev)
            prev = skey[base + q]
    if base == 0:
        f[0] = 0
    return f


def rerank_count(skey, n, tile, per):
    tiles = -(-n // tile)
    counts = np.zeros(tiles, np.int64)
    for b in range(tiles):
        for t in range(tile // per):
            counts[b] += _load_flags(skey, b * tile + t * per, n, per).sum()
    return counts


def rerank(skey, order, n, counts, rnd, distinct, done, rank, tile, per, force_write=False):
    """bwt_rerank, CTA by CTA. Returns how often each rank slot was written
    and the classes it would have written at a stall (None otherwise)."""
    writes = np.zeros(n, np.int64)
    would = np.full(n, -1, np.int64)
    if rnd > 0 and done[rnd - 1]:
        return writes, None
    prev_distinct = distinct[rnd - 1] if rnd > 0 else None
    for b in range(counts.size):
        before = counts[:b].sum()
        classes = counts.sum() + 1
        stall = rnd > 0 and classes == prev_distinct
        excl = before
        for t in range(tile // per):
            base = b * tile + t * per
            f = _load_flags(skey, base, n, per)
            cls = excl
            for q in range(per):
                if base + q < n:
                    cls += f[q]
                    would[order[base + q]] = cls
                    if not stall or force_write:
                        rank[order[base + q]] = cls
                        writes[order[base + q]] += 1
            excl += f.sum()
    # block 0, thread 0, after every CTA has read slot rnd - 1
    distinct[rnd] = classes
    done[rnd] = int(classes == n or stall)
    return writes, (would if stall else None)


def last_column(block, rank, n, size):
    last = np.full(size, 255, np.uint8)  # torch.empty: every lane must be written
    writes = np.zeros(size, np.int64)
    for j in range(size):
        if j >= n:
            last[j] = 0
            writes[j] += 1
        else:
            at = rank[_wrap(j, 1 % n, n)]
            last[at] = block[j]
            writes[at] += 1
    assert (writes == 1).all()
    return int(rank[0]), last


def tie_route(block, rank, n, P, size):
    j = np.arange(n)
    keys = np.full(P, PAD_KEY, np.int64)
    keys[:n] = (rank[_wrap(j, 1 % n, n)].astype(np.int64) << MAX_LOG2) | j
    key = int((rank[:n] < rank[0]).sum())
    col = np.sort(keys)
    last = np.zeros(size, np.uint8)
    last[:n] = block[col[:n] & ((1 << MAX_LOG2) - 1)]
    return key, last


# --------------------------------------------------------------- the host


class NoFixpoint(Exception):
    pass


def round_cap(n: int) -> int:
    """One more than the most doubling rounds a block of n bytes can run:
    round r compares 3 * 2^(r+1) bytes, and once that covers n the next
    round must stall."""
    c = 0
    while (3 << c) < n:
        c += 1
    return c + 2


def emulate(c: bytes, size=N, tile=32, per=4, seed=0, cap=None, force_write=False):
    """tpubz_bwt_forward's loop. Returns key, last and a record of the run."""
    block = np.frombuffer(c, np.uint8)
    n = block.size
    P = padded_length(n)
    cap = round_cap(n) if cap is None else cap
    rng = np.random.default_rng(seed)
    rank = np.full(P, -7, np.int32)
    distinct = np.full(STATE_SLOTS, -99, np.int64)
    done = np.full(STATE_SLOTS, -99, np.int64)
    log = {"rounds_enqueued": 0, "skipped": 0, "stalls": []}

    def enqueue_round(r):
        log["rounds_enqueued"] += 1
        if r > 0 and done[r - 1]:
            # every kernel of the round returns at once
            before = (rank.copy(), distinct.copy(), done.copy())
            writes, _ = rerank(None, None, n, np.zeros(0), r, distinct, done, rank, tile, per)
            assert not writes.any()
            assert all(np.array_equal(a, b) for a, b in zip(before, (rank, distinct, done)))
            log["skipped"] += 1
            return
        if r == 0:
            keys, pos = seed_keys(block, n, P)
        else:
            keys, pos = round_keys(rank, n, P, (3 << r) % n)
        skey, order = sort_2op(keys, pos, rng)
        assert (skey[n:] == PAD_KEY).all() and (skey[:n] < PAD_KEY).all()
        counts = rerank_count(skey, n, tile, per)
        old = rank[:n].copy()
        writes, would = rerank(skey, order, n, counts, r, distinct, done, rank, tile, per,
                               force_write)
        if would is None:
            assert (writes == 1).all()  # every rank slot exactly once
        else:
            assert (writes == (1 if force_write else 0)).all()
            log["stalls"].append((old, would))

    enqueue_round(0)
    r, prev = 0, -1
    while True:
        ahead = r + 1 < cap
        if ahead:
            enqueue_round(r + 1)
        d = int(distinct[r])  # the pinned word after round r's event
        if d == n or d == prev:
            break
        if not ahead:
            raise NoFixpoint(r)
        prev, r = d, r + 1
    log.update(rounds=r + 1, distinct=d)
    assert (rank[n:] == -7).all()  # pad lanes never reach rank
    if d == n:
        key, last = last_column(block, rank, n, size)
        log["route"] = "permutation"
        log["tie_route"] = tie_route(block, rank, n, P, size)
    else:
        key, last = tie_route(block, rank, n, P, size)
        log["route"] = "ties"
    return key, last, log


# --------------------------------------------------------------- the tests


@pytest.mark.parametrize("case", CASE_IDS)
def test_emulated_call_matches_tpubz_and_plain(case):
    """Key and every lane of last equal tpubz's bwt_forward (jit on the CPU),
    the port's plain version and the host oracle, for three tile shapes and
    tie orders; pad lanes are zero; the rounds stay within the cap."""
    c = CASES[case]
    n = len(c)
    jkey, jlast = _jax_bwt(jnp.asarray(_pad(c)), jnp.int32(n))
    rkey, rlast = bwt_forward_ref(torch.from_numpy(_pad(c)), n)
    hkey, hlast = bwt_encode(np.frombuffer(c, np.uint8))
    assert int(rkey) == int(jkey) == hkey
    assert np.array_equal(rlast.numpy(), np.asarray(jlast))
    for tile, per, seed in ((16, 2, 0), (32, 4, 1), (64, 8, 2)):
        key, last, log = emulate(c, tile=tile, per=per, seed=seed)
        assert key == hkey
        assert np.array_equal(last, np.asarray(jlast))
        assert np.array_equal(last[:n], hlast) and not last[n:].any()
        assert log["rounds"] <= round_cap(n)


@pytest.mark.parametrize("case", CASE_IDS)
def test_plain_version_is_the_cpu_path(case):
    """On a CPU tensor bwt_forward is bwt_forward_ref."""
    c = CASES[case]
    data = torch.from_numpy(_pad(c))
    key, last = bwt_forward(data, len(c))
    rkey, rlast = bwt_forward_ref(data, len(c))
    assert int(key) == int(rkey) and torch.equal(last, rlast)
    assert key.dtype == torch.int64 and key.dim() == 0 and last.dtype == torch.uint8


@pytest.mark.parametrize("case", CASE_IDS)
def test_one_round_ahead_schedule(case):
    """The host enqueues at most one round more than it runs; that round's
    kernels, gated by the slot of the round before, change nothing (checked
    inside the emulation); the stop rule is the plain version's."""
    c = CASES[case]
    n = len(c)
    _, _, log = emulate(c)
    assert log["rounds_enqueued"] - log["rounds"] == log["skipped"]
    assert log["skipped"] == (1 if log["rounds"] < round_cap(n) else 0)
    assert log["route"] == ("permutation" if log["distinct"] == n else "ties")
    # the plain version's rounds: count its 2op sorts
    calls = []
    orig = suffix_sort.bitonic_2op
    suffix_sort.bitonic_2op = lambda k, p: calls.append(1) or orig(k, p)
    try:
        bwt_forward_ref(torch.from_numpy(_pad(c)), n)
    finally:
        suffix_sort.bitonic_2op = orig
    assert log["rounds"] == len(calls)


@pytest.mark.parametrize("case", PERIODIC)
def test_stall_round_rerank_equals_old_rank(case):
    """A round that leaves the class count unchanged would write, lane for
    lane, the rank it found: skipping the write and making it agree."""
    c = CASES[case]
    key, last, log = emulate(c)
    assert log["route"] == "ties" and len(log["stalls"]) == 1
    old, would = log["stalls"][0]
    assert np.array_equal(old, would)
    fkey, flast, flog = emulate(c, force_write=True)
    assert (fkey, flog["rounds"]) == (key, log["rounds"]) and np.array_equal(flast, last)


@pytest.mark.parametrize("case", [c for c in CASE_IDS if c not in PERIODIC])
def test_permutation_route_equals_sort_route(case):
    """With every rotation its own class, the scatter through rank gives the
    key and the column of the keys-only sort."""
    c = CASES[case]
    key, last, log = emulate(c)
    assert log["route"] == "permutation" and log["distinct"] == len(c)
    tkey, tlast = log["tie_route"]
    assert key == tkey and np.array_equal(last, tlast)


@pytest.mark.parametrize("case", ["near_periodic", "period64_flip", "text"])
def test_round_cap_raises_short_of_a_fixpoint(case):
    """A cap below the rounds a block needs ends the loop with an error and
    no speculative round past it; the real cap is never reached."""
    c = CASES[case]
    _, _, log = emulate(c)
    assert 2 <= log["rounds"] < round_cap(len(c))
    with pytest.raises(NoFixpoint):
        emulate(c, cap=log["rounds"] - 1)
    _, _, tight = emulate(c, cap=log["rounds"])
    assert tight["rounds_enqueued"] == tight["rounds"] == log["rounds"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 100, 1 << 10, 900_000, 1 << 20])
def test_round_cap_covers_n_and_fits_the_state_record(n):
    """The emulated cap covers n (3 * 2^(cap-2) >= n, the round after
    stalls), is the least that does, and fits the state's slots. The
    library's own sizes are held to the same on the card
    (tests/test_torch_cuda.py)."""
    cap = round_cap(n)
    assert 3 << (cap - 2) >= n and (cap == 2 or 3 << (cap - 3) < n)
    assert cap <= STATE_SLOTS


def test_kernel_source_sorts_only_through_the_bitonic_runner():
    """csrc/bwt.cu reaches the sorts through the shared header and uses no
    library's sort or scan; the wrapper keeps no copy of its layout."""
    import inspect
    import os

    from tpubz_torch.kernels import _build

    src = open(os.path.join(_build.CSRC_DIR, "bwt.cu")).read()
    assert '#include "bitonic.cuh"' in src and "tpubz::bitonic_run_i64" in src
    for banned in ("cub::", "thrust::", "#include <cub", "#include <thrust"):
        assert banned not in src
    wrapper = inspect.getsource(suffix_sort)
    assert "tpubz_bwt_sizes" in wrapper and "torch.sort" not in wrapper


def test_cpu_call_edges():
    """n = 0 gives key 0 and a zero column; n above 2^20 raises, on the CPU
    path as on the card's."""
    key, last = bwt_forward(torch.from_numpy(_pad(b"abc")), 0)
    assert int(key) == 0 and key.dtype == torch.int64 and not last.any() and last.shape == (N,)
    with pytest.raises(ValueError):
        bwt_forward(torch.zeros((1 << MAX_LOG2) + 256, dtype=torch.uint8), (1 << MAX_LOG2) + 1)


@pytest.mark.parametrize("stage", ["full", "bwt"])
def test_stream_spans_marks_every_block(stage, monkeypatch, tmp_path):
    """stage_probe.stream_spans at level 1 on the CPU: one span per block,
    inside the wall, and the encoder's methods restored."""
    from tpubz_torch import stage_probe
    from tpubz_torch.block.encode import DeviceBlockEncoder
    from tpubz_torch.stream import api, rigprofile

    monkeypatch.setenv("TPUBZ_TORCH_CACHE", str(tmp_path / "cache"))
    rigprofile.reset_memo()
    before = DeviceBlockEncoder.transform, DeviceBlockEncoder.fetch_bwt_async
    d = bytes(np.random.default_rng(5).integers(0, 7, 350_000, dtype=np.uint8))
    out = stage_probe.stream_spans(d, 1, stage, device="cpu")
    rigprofile.reset_memo()
    assert out["blocks"] == api.last_stream_stats["blocks"] >= 3
    assert 0 < out["block_span_ms"] <= out["wall_ms"]
    assert out["outside_spans_share"] == 1 - out["block_span_ms"] / out["wall_ms"]
    assert (DeviceBlockEncoder.transform, DeviceBlockEncoder.fetch_bwt_async) == before

"""The BWT's library call (csrc/bwt.cu on csrc/radix.cuh), emulated in
numpy on the CPU with the kernels' index math, against tpubz's bwt_forward
and the port's plain version.

The CUDA kernels run only on the card. tests/torch_bwt_emulation.py runs
each of them CTA by CTA as its source writes it (the round's keys and their
histogram, every radix pass with its tile tickets and decoupled look-back,
the re-rank's tile aggregates and its group-start ranks, slots and
compaction, the per-round state record and the pinned words), with small
tiles (16-64 keys) and 4-bit digits so that classes and digit runs cross
many tiles, CTAs stepped in a random order, and the host's loop with its
one-round-ahead schedule and round cap; then the last column from sa. Every
comparison is exact: tolerance 0.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpubz.hostref.bwt import bwt_encode
from tpubz.kernels import suffix_sort as jsort
from tpubz_torch.kernels import suffix_sort
from tpubz_torch.kernels.suffix_sort import bwt_forward, bwt_forward_ref

from torch_bwt_emulation import (MAX_ROUNDS, NoFixpoint, Shape, emulate_bwt, passes_of,
                                 round_cap, KEY_HI, KEY_LO)

torch.set_num_threads(2)

N = 2304  # 9 chunks of 256: one jit shape for every case
MAX_LOG2 = 20
# radix tiles of 16, 32 and 64 keys and re-rank tiles of 16, 32 and 64,
# 4-bit digits: 10 passes a round
SHAPES = [Shape(2, 4, 2, 4, 4, 4), Shape(2, 8, 2, 4, 8, 4), Shape(2, 8, 4, 4, 8, 8)]

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


# --------------------------------------------------------------- the tests


@functools.lru_cache(maxsize=None)
def _emulated(case: str, shape: int, seed: int = 0):
    return emulate_bwt(CASES[case], N, SHAPES[shape], seed=shape + seed)


def _plain_rounds(c: bytes):
    """Per round of the plain version: (active rotations sorted, classes of
    all n rotations after it, rotations left in classes of size >= 2)."""
    block = torch.frombuffer(bytearray(c), dtype=torch.uint8)
    rounds = []
    for _, keys, rank, _ in suffix_sort._doubling(block):
        _, counts = rank.unique(return_counts=True)
        rounds.append((keys.numel(), counts.numel(), int(counts[counts > 1].sum())))
    return rounds


@pytest.mark.parametrize("case", CASE_IDS)
def test_emulated_call_matches_tpubz_and_plain(case):
    """Key and every lane of last equal tpubz's bwt_forward (jit on the CPU),
    the port's plain version and the host oracle, for three tile shapes and
    CTA orders; pad lanes are zero; the rounds stay within the cap."""
    c = CASES[case]
    n = len(c)
    jkey, jlast = _jax_bwt(jnp.asarray(_pad(c)), jnp.int32(n))
    rkey, rlast = bwt_forward_ref(torch.from_numpy(_pad(c)), n)
    hkey, hlast = bwt_encode(np.frombuffer(c, np.uint8))
    assert int(rkey) == int(jkey) == hkey
    assert np.array_equal(rlast.numpy(), np.asarray(jlast))
    for shape in range(len(SHAPES)):
        key, last, log = _emulated(case, shape)
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
def test_one_round_ahead_schedule(case, monkeypatch):
    """The host enqueues at most one round more than it runs; that round's
    kernels, gated by the state of the round before, write nothing (checked
    inside the emulation); the rounds and each round's active count are the
    plain version's."""
    c = CASES[case]
    n = len(c)
    _, _, log = _emulated(case, 1)
    assert log["rounds_enqueued"] - log["rounds"] == log["skipped"]
    assert log["skipped"] == (1 if log["rounds"] < round_cap(n) else 0)
    sorted_sizes = []
    orig = suffix_sort.radix_sort_ref

    def counted(keys, *args):
        sorted_sizes.append(keys.numel())
        return orig(keys, *args)

    monkeypatch.setattr(suffix_sort, "radix_sort_ref", counted)
    bwt_forward_ref(torch.from_numpy(_pad(c)), n)
    assert log["m"] == sorted_sizes


@pytest.mark.parametrize("case", CASE_IDS)
def test_state_record_and_pinned_words(case):
    """Each round's pinned words (the next round's active count, the classes
    of all n rotations, the split flag) are the plain version's; every slot
    of an active class is written exactly once a round; round 0 sorts all n
    rotations."""
    c = CASES[case]
    _, _, log = _emulated(case, 0)
    plain = _plain_rounds(c)
    assert log["m"][0] == len(c) and len(plain) == log["rounds"]
    before = 1  # round 0 starts from one class
    for r, (words, (m, classes, left)) in enumerate(zip(log["pinned"], plain)):
        assert log["m"][r] == m
        assert list(words) == [left, classes, int(classes > before)]
        writes = log["slot_writes"][r]
        assert set(np.unique(writes)) <= {0, 1} and writes.sum() == m
        before = classes
    *running, final = log["pinned"]
    assert all(w[0] > 0 and w[2] == 1 for w in running)
    assert final[0] == 0 or final[2] == 0


@pytest.mark.parametrize("case", ["n1", "n257", "n2049", "near_periodic", "period64_flip", "text"])
def test_ctas_past_the_active_count_exit(case):
    """The grids are sized for n; in each round only the CTAs below the
    round's active count work (histogram and every pass), the tickets of
    each pass are 0 .. tiles(m) - 1, and look-back chains crossed tiles."""
    c = CASES[case]
    shape = SHAPES[0]
    _, _, log = _emulated(case, 0)
    rl = log["radix"]
    launches = 1 + len(passes_of(KEY_LO, KEY_HI, shape.digit_bits))
    assert len(rl.working) == launches * log["rounds"]
    for r, m in enumerate(log["m"]):
        for k in range(launches):
            assert rl.launched[r * launches + k] == shape.tiles(len(c))
            assert rl.working[r * launches + k] == shape.tiles(m)
    assert all(sorted(t) == list(range(len(t))) for t in rl.tickets)
    if len(c) > shape.tile:
        assert rl.lookback_steps > 0


@pytest.mark.parametrize("case", PERIODIC)
def test_stall_round_rerank_equals_old_rank(case):
    """A round in which no class splits (the periodic fixpoint) writes, lane
    for lane, the rank it found, and keeps every rotation active; a block
    that stops after round 0 is one byte repeated (a single class)."""
    c = CASES[case]
    _, _, log = _emulated(case, 0)
    assert log["pinned"][-1][2] == 0  # no split
    assert log["pinned"][-1][0] == log["m"][-1]  # no rotation left alone
    if log["rounds"] == 1:
        assert len(set(c)) == 1 and not log["rank"].any()
    else:
        assert np.array_equal(log["rank_before"][-1], log["rank"])


@pytest.mark.parametrize("case", [c for c in CASE_IDS if c not in PERIODIC])
def test_last_column_from_sa_equals_the_scatter_through_rank(case):
    """With every rotation its own class, sa is rank's inverse, and the
    gather through sa gives the key and the column of the scatter
    last[rank[(j + 1) mod n]] = block[j]."""
    c = CASES[case]
    n = len(c)
    key, last, log = _emulated(case, 0)
    rank, sa = log["rank"], log["sa"]
    assert log["pinned"][-1][0] == 0 and log["pinned"][-1][1] == n
    assert np.array_equal(sa[rank], np.arange(n))
    scattered = np.zeros(n, np.uint8)
    scattered[rank[(np.arange(n) + 1) % n]] = np.frombuffer(c, np.uint8)
    assert np.array_equal(last[:n], scattered) and key == rank[0]


@pytest.mark.parametrize("case", PERIODIC)
def test_any_order_inside_a_tied_class_gives_the_column(case):
    """Tied classes are identical rotations: sa rotated inside each class
    gives the same last column, and every class keeps its slots."""
    c = CASES[case]
    n = len(c)
    block = np.frombuffer(c, np.uint8)
    key, last, log = _emulated(case, 0)
    rank, sa = log["rank"], log["sa"]
    assert np.array_equal(rank[sa], np.maximum.accumulate(np.where(
        np.r_[True, rank[sa][1:] != rank[sa][:-1]], np.arange(n), 0)))
    shuffled = sa.copy()
    for g in np.unique(rank):
        slots = np.nonzero(rank[sa] == g)[0]
        shuffled[slots] = np.roll(sa[slots], 1)
    assert not np.array_equal(shuffled, sa)
    assert np.array_equal(block[(shuffled + n - 1) % n], last[:n])


@pytest.mark.parametrize("case", ["near_periodic", "period64_flip", "text"])
def test_round_cap_raises_short_of_a_fixpoint(case):
    """A cap below the rounds a block needs ends the loop with an error and
    no speculative round past it; the real cap is never reached."""
    c = CASES[case]
    _, _, log = _emulated(case, 1)
    assert 2 <= log["rounds"] < round_cap(len(c))
    with pytest.raises(NoFixpoint):
        emulate_bwt(c, N, SHAPES[1], cap=log["rounds"] - 1)
    _, _, tight = emulate_bwt(c, N, SHAPES[1], cap=log["rounds"])
    assert tight["rounds_enqueued"] == tight["rounds"] == log["rounds"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 100, 1 << 10, 900_000, 1 << 20])
def test_round_cap_covers_n_and_fits_the_state_record(n):
    """The cap covers n (5 * 2^(cap-2) >= n, the round after leaves no
    rotation or splits no class), is the least that does, fits the state's
    slots, and is the plain version's. The library's own sizes are held to
    the same on the card (tests/test_torch_cuda.py)."""
    cap = round_cap(n)
    assert 5 << (cap - 2) >= n and (cap == 2 or 5 << (cap - 3) < n)
    assert cap <= MAX_ROUNDS and cap == suffix_sort.round_cap(n)


def test_kernel_source_sorts_only_through_radix():
    """csrc/bwt.cu sorts only through csrc/radix.cuh's passes and names no
    library sort or scan and no bitonic runner; the wrapper keeps no copy of
    its layout and calls no torch sort."""
    import inspect
    import os

    from tpubz_torch.kernels import _build

    src = open(os.path.join(_build.CSRC_DIR, "bwt.cu")).read()
    assert '#include "radix.cuh"' in src and "tpubz::radix::enqueue_passes" in src
    for banned in ("cub::", "thrust::", "#include <cub", "#include <thrust", "bitonic"):
        assert banned not in src
    wrapper = inspect.getsource(suffix_sort)
    assert "tpubz_bwt_sizes" in wrapper and "torch.sort" not in wrapper
    assert "bitonic" not in wrapper


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

"""The radix sort under the BWT (tpubz_torch/kernels/radix.py, csrc/radix.cu
and csrc/radix.cuh) on the CPU: its plain version against numpy's stable
argsort, and the kernels, emulated CTA by CTA in numpy
(tests/torch_bwt_emulation.py: tile tickets, per-warp ranking, decoupled
look-back over tagged status words, the coalesced write), against the plain
version. Keys are int64, sorted by a range of their bits; every comparison
is exact: tolerance 0.
"""
import inspect
import os
import re

import numpy as np
import pytest

import torch

from tpubz_torch.kernels import _build, radix
from tpubz_torch.kernels.radix import radix_sort, radix_sort_ref

from torch_bwt_emulation import (FLAG_MASK, INCLUSIVE, TAG_SHIFT, Log, Shape, emulate_sort,
                                 passes_of, tag_of)

torch.set_num_threads(2)


def _keys(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    sizes = {"n1": 1, "n2": 2, "p2m1": (1 << 12) - 1, "p2": 1 << 12, "p2p1": (1 << 12) + 1}
    if case == "random60":
        return rng.integers(0, 1 << 60, 50_000, dtype=np.int64)
    if case == "all_equal":
        return np.full(3000, 0x0ABCDE << 20, np.int64) | np.arange(3000)
    if case == "few_values":  # long runs of each digit, the low bits a position
        return (rng.integers(0, 3, 20_000, dtype=np.int64) << 40) | np.arange(20_000)
    return rng.integers(0, 1 << 60, sizes[case], dtype=np.int64)


CASES = ["random60", "all_equal", "few_values", "n1", "n2", "p2m1", "p2", "p2p1"]


def _numpy_sorted(keys: np.ndarray, lo: int, hi: int) -> np.ndarray:
    field = (keys >> lo) & ((1 << (hi - lo)) - 1)
    return keys[np.argsort(field, kind="stable")]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("digit_bits", [8, 10])
def test_ref_matches_numpy_stable_argsort(digit_bits, case):
    """radix_sort_ref by bits 20-59 (the BWT's) equals numpy's stable sort
    by that field: equal fields keep their input order."""
    keys = _keys(case)
    got = radix_sort_ref(torch.from_numpy(keys), 20, 60, digit_bits).numpy()
    assert np.array_equal(got, _numpy_sorted(keys, 20, 60))


@pytest.mark.parametrize("lo,hi", [(0, 63), (7, 13), (20, 60), (41, 50)])
def test_ref_sorts_any_bit_range(lo, hi):
    """Any range, a last digit narrower than the rest included; the bits
    outside the range do not order the keys."""
    keys = np.random.default_rng(lo).integers(0, 1 << 62, 5000, dtype=np.int64)
    for digit_bits in (4, 8, 10):
        got = radix_sort_ref(torch.from_numpy(keys), lo, hi, digit_bits).numpy()
        assert np.array_equal(got, _numpy_sorted(keys, lo, hi))


# radix tiles of 16, 32 and 64 keys (4-bit digits: 10 passes over bits 20-59)
SHAPES = [Shape(2, 4, 2, 4), Shape(2, 8, 2, 4), Shape(2, 8, 4, 4)]


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 63, 64, 65, 700])
def test_emulated_kernels_match_the_plain_version(shape, n):
    """The histogram launch and the passes, CTA by CTA in a random order,
    give radix_sort_ref's keys, on random keys and on keys with few digit
    values (long runs crossing many tiles)."""
    rng = np.random.default_rng(n)
    for keys in (rng.integers(0, 1 << 60, n, dtype=np.int64),
                 (rng.integers(0, 2, n, dtype=np.int64) << 44) | np.arange(n)):
        got = emulate_sort(keys, 20, 60, SHAPES[shape], np.random.default_rng(shape))
        want = radix_sort_ref(torch.from_numpy(keys), 20, 60, 4).numpy()
        assert np.array_equal(got, want)


def test_emulated_tickets_and_lookback():
    """Each pass hands out the tickets 0 .. tiles - 1 once; every tile ends a
    pass with an inclusive word of the pass's tag for each digit, and the
    last tile's words add up to the histogram (each digit's total); tiles
    looked back across other tiles and sometimes spun."""
    shape = SHAPES[0]
    n = 1000
    keys = np.random.default_rng(3).integers(0, 1 << 60, n, dtype=np.int64)
    bins = 1 << shape.digit_bits
    status = np.zeros(shape.tiles(n) * bins, np.int64)
    tickets = np.zeros(shape.max_passes, np.int64)
    log = Log()
    emulate_sort(keys, 20, 60, shape, np.random.default_rng(0), log=log, status=status,
                 tickets=tickets, rnd=3)
    plist = passes_of(20, 60, shape.digit_bits)
    assert list(tickets[: len(plist)]) == [shape.tiles(n)] * len(plist)
    assert all(sorted(t) == list(range(shape.tiles(n))) for t in log.tickets)
    last_tag = tag_of(3, len(plist) - 1, shape.max_passes)
    assert (status >> TAG_SHIFT == last_tag).all() and (status & FLAG_MASK == INCLUSIVE).all()
    shift, width = plist[-1]
    counts = np.bincount((keys >> shift) & ((1 << width) - 1), minlength=bins)
    assert np.array_equal(status[-bins:] & ((1 << 21) - 1), counts)
    assert log.lookback_steps > shape.tiles(n) and log.spins > 0


def test_tags_fit_the_status_word():
    """Every (round, pass) of a BWT call has its own nonzero tag below 2^9,
    so zeroed words and an earlier pass's words never pass for this one's."""
    tags = {tag_of(r, p) for r in range(24) for p in range(8)}
    assert len(tags) == 24 * 8 and min(tags) > 0 and max(tags) < 1 << (32 - TAG_SHIFT)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    """A CPU tensor runs the plain version in the kernels' digits (the one
    width of csrc/radix.cuh), and no launch is counted."""
    keys = torch.from_numpy(_keys("random60"))
    before = (radix.LAUNCHES, radix.SORTS, radix.PASS_LAUNCHES)
    assert torch.equal(radix_sort(keys, 20, 60), radix_sort_ref(keys, 20, 60, radix.DIGIT_BITS))
    assert torch.equal(radix_sort(keys, 0, 63), radix_sort_ref(keys, 0, 63, radix.DIGIT_BITS))
    assert (radix.LAUNCHES, radix.SORTS, radix.PASS_LAUNCHES) == before
    header = open(os.path.join(_build.CSRC_DIR, "radix.cuh")).read()
    assert re.findall(r"constexpr int kDigitBits = (\d+);", header) == [str(radix.DIGIT_BITS)]


def test_wrapper_rejects_what_the_kernels_do_not_take():
    keys = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(TypeError):
        radix_sort(keys.int(), 20, 60)
    with pytest.raises(TypeError):
        radix_sort(keys.view(2, 4), 20, 60)
    for lo, hi in ((20, 20), (-1, 5), (0, 64)):
        with pytest.raises(ValueError):
            radix_sort(keys, lo, hi)
    with pytest.raises(ValueError):
        radix_sort(torch.zeros((1 << 20) + 1, dtype=torch.int64), 20, 60)


def test_sources_use_no_library_sort():
    """csrc/radix.cu and csrc/radix.cuh name no cub, thrust or torch sort,
    and the wrapper reaches the library only through its two entry points."""
    for name in ("radix.cu", "radix.cuh"):
        src = open(os.path.join(_build.CSRC_DIR, name)).read()
        for banned in ("cub::", "thrust::", "#include <cub", "#include <thrust"):
            assert banned not in src
    wrapper = inspect.getsource(radix)
    assert "tpubz_radix_sort" in wrapper and "tpubz_radix_sizes" in wrapper
    assert "torch.sort" not in wrapper

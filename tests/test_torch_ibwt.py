"""The port's inverse BWT against tpubz's, on the CPU, tolerance 0.

``kernels/ibwt.py``'s plain versions, which the wrappers run for CPU
tensors, against ``tpubz/kernels/ibwt.py``: ``next_pointers`` against
``_next_pointers`` (jitted on the JAX CPU backend) and
``bwt_inverse_device`` against tpubz's and against the original data, on
the cases of ``tests/test_device_kernels.py``'s device inverse test, each
with pad lanes past n, plus a periodic block (tied rotations), one byte
and no byte. The CUDA call's orbit (csrc/ibwt.cu: list ranking over
sampled splitters, three levels) is emulated kernel by kernel in numpy
(``tests/torch_ibwt_emulation.py``) and held to tpubz's inverse on the same
cases at several splitter densities, every row a splitter and p_0 the only
one among them, and on periodic blocks.
"""
import functools

import numpy as np
import pytest
import torch

from tpubz.hostref.bwt import bwt_decode_fast, bwt_encode
from tpubz.kernels import ibwt as tibwt

from tpubz_torch.kernels import ibwt
from tpubz_torch.kernels.suffix_sort import bwt_forward

from torch_ibwt_emulation import splitter_inverse


def _cases():
    rng = np.random.default_rng(1234)
    return {
        "banana": b"banana" * 100,
        "random": bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
        "one_run": b"a" * 2000,
        "one_byte": b"x",
        "four_symbols": bytes(rng.integers(0, 4, 9000, dtype=np.uint8)),
        "periodic": b"abc" * 333,
        "empty": b"",
    }


@pytest.mark.parametrize("pad", [0, 37])
@pytest.mark.parametrize("name", list(_cases()))
def test_ibwt_matches_tpubz(name, pad):
    """next_pointers equals tpubz's _next_pointers on the padded column
    (lanes >= n in position order after every byte), and
    bwt_inverse_device equals tpubz's inverse, the host decoder and the
    data."""
    d = _cases()[name]
    n = len(d)
    if n:
        key, last = bwt_encode(np.frombuffer(d, np.uint8))
        key = int(key)
    else:
        key, last = 0, np.zeros(0, np.uint8)
    col = np.zeros(n + pad, np.uint8)
    col[:n] = last
    got = ibwt.next_pointers(torch.from_numpy(col), n)
    assert got.dtype == torch.int32 and got.shape == (n + pad,)
    if col.size:
        want = np.asarray(tibwt._next_pointers(col, n))
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy()[n:], np.arange(n, n + pad))
    out = ibwt.bwt_inverse_device(key, torch.from_numpy(col), n)
    assert out.dtype == torch.uint8 and out.shape == (n,)
    assert bytes(out.numpy()) == d
    if n:
        assert np.array_equal(out.numpy(), tibwt.bwt_inverse_device(key, col, n))
        assert np.array_equal(out.numpy(), bwt_decode_fast(key, last))


def test_ibwt_on_the_ports_bwt_with_pad_lanes():
    """The inverse of the port's own BWT of a 4096-lane block with n = 3001
    (a near-periodic ab...abc block) gives the block back, and its next
    pointers equal tpubz's."""
    d = b"ab" * 1500 + b"c"
    data = torch.zeros(4096, dtype=torch.uint8)
    data[: len(d)] = torch.frombuffer(bytearray(d), dtype=torch.uint8)
    key, last = bwt_forward(data, len(d))
    nxt = ibwt.next_pointers(last, len(d))
    assert np.array_equal(nxt.numpy(), np.asarray(tibwt._next_pointers(last.numpy(), len(d))))
    assert bytes(ibwt.bwt_inverse_device(int(key), last, len(d)).numpy()) == d


# the walks the emulation runs: (log2 of the three levels' windows, whether
# level 1 picks rows, the bytes a level-1 walk keeps); "kernel" is
# csrc/ibwt.cu's, "every_row" makes each row a splitter, "only_p0" leaves p_0
# the only level-1 splitter (its walk is its whole cycle), "kept_4" copies
# four bytes a segment and walks on past them
WALKS = {
    "kernel": (ibwt.LOG_D, True, ibwt.KEPT),
    "every_row": ((0, 1, 1), True, ibwt.KEPT),
    "only_p0": (ibwt.LOG_D, False, ibwt.KEPT),
    "dense": ((1, 1, 1), True, ibwt.KEPT),
    "sparse": ((5, 2, 4), True, ibwt.KEPT),
    "kept_4": (ibwt.LOG_D, True, 4),
}


@functools.lru_cache(maxsize=None)
def _column(name, pad):
    """(data, key, padded column, tpubz's inverse) of a case."""
    d = _cases()[name] if name in _cases() else PERIODIC[name]
    n = len(d)
    key, last = bwt_encode(np.frombuffer(d, np.uint8)) if n else (0, np.zeros(0, np.uint8))
    col = np.zeros(n + pad, np.uint8)
    col[:n] = last
    want = tibwt.bwt_inverse_device(int(key), col, n) if n else np.zeros(0, np.uint8)
    return d, int(key), col, np.asarray(want)


def _cycle_length(key, col, n):
    nxt = np.argsort(np.where(np.arange(col.size) < n, col.astype(np.int64), 256), kind="stable")
    p = start = int(nxt[key])
    length = 0
    while True:
        p, length = int(nxt[p]), length + 1
        if p == start:
            return length


def _check_walk(name, pad, walk):
    d, key, col, want = _column(name, pad)
    n = len(d)
    logs, rows_picked, kept = WALKS[walk]
    out, rec = splitter_inverse(key, col, n, logs, rows_picked, np.random.default_rng(n + pad),
                                kept)
    assert out.dtype == np.uint8 and np.array_equal(out, want) and bytes(out) == d
    if n == 0:
        assert not any(rec.values())
        return rec
    orbit = _cycle_length(key, col, n)
    assert rec["launches"] == 4 and rec["orbit"] == orbit and n % orbit == 0
    assert 1 <= rec["segments"] <= rec["splitters"] and rec["longest"] >= 1
    assert rec["list_splitters"] >= 1 and rec["top_splitters"] >= 1
    if walk == "only_p0":
        assert rec["splitters"] == rec["segments"] == 1 and rec["longest"] == orbit
    if walk == "every_row":
        assert rec["splitters"] == n and rec["longest"] == 1 and rec["segments"] == orbit
    return rec


@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("pad", [0, 37])
@pytest.mark.parametrize("name", list(_cases()))
def test_splitter_walk_matches_tpubz(name, pad, walk):
    """csrc/ibwt.cu's orbit, emulated kernel by kernel (the walkers in a
    random order), equals tpubz's bwt_inverse_device and the data at
    several splitter densities; its record holds the cycle's length, the
    segments of p_0's cycle and the walks."""
    _check_walk(name, pad, walk)


PERIODIC = {
    "period_256": bytes(range(256)) * 40,  # 40 cycles of 256 rows: L < n
    "period_7_run": (b"aaaaaab" * 1500),  # long runs inside each period
}


@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("name", list(PERIODIC))
def test_splitter_walk_on_periodic_blocks(name, walk):
    """Tied rotations split nxt into n / L cycles: only p_0's is written,
    then repeated; walkers on the other cycles write nothing."""
    rec = _check_walk(name, 0, walk)
    assert rec["orbit"] < len(PERIODIC[name])


def test_ibwt_rejects_what_it_does_not_take():
    last = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(TypeError):
        ibwt.next_pointers(last.int(), 5)
    with pytest.raises(ValueError):
        ibwt.next_pointers(last, 11)
    with pytest.raises(ValueError):
        ibwt.bwt_inverse_device(5, last, 5)
    with pytest.raises(ValueError):
        ibwt.bwt_inverse_device(-1, last, 5)

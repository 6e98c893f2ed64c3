"""The port's inverse BWT against tpubz's, on the CPU, tolerance 0.

``kernels/ibwt.py``'s plain versions, which the wrappers run for CPU
tensors, against ``tpubz/kernels/ibwt.py``: ``next_pointers`` against
``_next_pointers`` (jitted on the JAX CPU backend) and
``bwt_inverse_device`` against tpubz's and against the original data, on
the cases of ``tests/test_device_kernels.py``'s device inverse test, each
with pad lanes past n, plus a periodic block (tied rotations), one byte
and no byte. The round count the CUDA call reports is held to the
iterations of tpubz's loop.
"""
import numpy as np
import pytest
import torch

from tpubz.hostref.bwt import bwt_decode_fast, bwt_encode
from tpubz.kernels import ibwt as tibwt

from tpubz_torch.kernels import ibwt
from tpubz_torch.kernels.suffix_sort import bwt_forward


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


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 9, 1000, 900_000])
def test_rounds_for_counts_tpubz_doubling_steps(n):
    """rounds_for(n) is the number of gather steps of tpubz's loop."""
    filled, steps = (1, 0) if n else (0, 0)
    while 0 < filled < n:
        filled += min(filled, n - filled)
        steps += 1
    assert ibwt.rounds_for(n) == steps


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

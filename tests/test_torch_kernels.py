"""The port's kernels (tpubz_torch.kernels) against tpubz's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
(on the CPU backend; the Pallas kernel in interpret mode) and its torch
counterpart. The codec is integer, so every comparison is bit-exact:
tolerance 0. N = 1024 with the production chunk of 256.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpubz.hostref.bwt import bwt_encode
from tpubz.hostref.mtf_rle2 import mtf_rle2_encode
from tpubz.kernels import mtf as jmtf
from tpubz.kernels import rle2 as jrle2
from tpubz.kernels import suffix_sort as jsort
from tpubz_torch.kernels import mtf as tmtf
from tpubz_torch.kernels.mtf import mtf_parts, mtf_ranks
from tpubz_torch.kernels.rle2 import num_digits, rle2_encode
from tpubz_torch.kernels.suffix_sort import bwt_forward

# the test workers share the host's cores: keep torch's intra-op pool small
torch.set_num_threads(2)

N = 1024
CHUNK = 256

_rng = np.random.default_rng(20261016)
# tests/test_device_kernels.py's shared cases, plus n not a multiple of 256,
# a near-periodic block and all 256 byte values (MTF rank 255, RLE2 >= 256)
CASES = {
    "banana": b"banana" * 30,
    "aaaa": b"aaaa" * 100,
    "ab": b"ab" * 300,
    "random256": bytes(_rng.integers(0, 256, 1000, dtype=np.uint8)),
    "random4": bytes(_rng.integers(0, 4, 1024, dtype=np.uint8)),
    "n1": b"x",
    "n777": bytes(_rng.integers(0, 20, 777, dtype=np.uint8)),
    "near_periodic": b"ab" * 500 + b"c",
    "all256": bytes(range(256)) * 4,
}
CASE_IDS = list(CASES)


def _pad(c: bytes) -> np.ndarray:
    p = np.zeros(N, np.uint8)
    p[: len(c)] = np.frombuffer(c, np.uint8)
    return p


_jax_bwt = jax.jit(jsort.bwt_forward)
_jax_mtf = jax.jit(jmtf.mtf_ranks, static_argnames=("chunk",))


@jax.jit
def _jax_chain(last, n):
    ranks, used = jmtf.mtf_ranks(last, n, chunk=CHUNK)
    return jrle2.rle2_encode(ranks, n, jnp.sum(used) + 1)


@pytest.mark.parametrize("case", CASE_IDS)
def test_bwt_forward_matches_tpubz_and_hostref(case):
    """Key and last column equal tpubz's bwt_forward (jit on CPU) and the
    host oracle; pad lanes are zero. Bit-exact (tolerance 0)."""
    c = CASES[case]
    n = len(c)
    key, last = bwt_forward(torch.from_numpy(_pad(c)), n)
    jkey, jlast = _jax_bwt(jnp.asarray(_pad(c)), jnp.int32(n))
    hkey, hlast = bwt_encode(np.frombuffer(c, np.uint8))
    last = last.numpy()
    assert int(key) == int(jkey) == hkey
    assert np.array_equal(last, np.asarray(jlast))
    assert np.array_equal(last[:n], hlast)
    assert not last[n:].any()


@pytest.mark.parametrize("case", CASE_IDS)
def test_mtf_ranks_matches_tpubz(case):
    """ranks[:n] and used equal tpubz's mtf_ranks on the same last column.
    Bit-exact (tolerance 0); pad lanes are unspecified."""
    c = CASES[case]
    n = len(c)
    _, hlast = bwt_encode(np.frombuffer(c, np.uint8))
    last = _pad(bytes(hlast))
    ranks, used = mtf_ranks(torch.from_numpy(last), n, CHUNK)
    jranks, jused = _jax_mtf(jnp.asarray(last), jnp.int32(n), chunk=CHUNK)
    assert ranks.dtype == torch.int32 and ranks.shape == (N,)
    assert np.array_equal(ranks.numpy()[:n], np.asarray(jranks)[:n])
    assert np.array_equal(used.numpy(), np.asarray(jused))


def _tpubz_pallas_ranks(lprev, lnext, keyi, keyrow):
    """tpubz's fused ranks with the Pallas dominance kernel, which runs in
    interpret mode on the CPU backend."""
    return np.asarray(
        jmtf._ranks_from_parts(
            *(jnp.asarray(a) for a in (lprev, lnext, keyi, keyrow)),
            CHUNK,
            use_pallas=True,
        )
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_ranks_from_parts_ref_matches_pallas_random(seed):
    """The plain version of the CUDA kernel against tpubz's Pallas kernel on
    seeded random (16, 256) parts, where keys repeat: this holds the Pallas
    form of case 2 (srank compares, not keyi compares). Bit-exact."""
    rng = np.random.default_rng(seed)
    nc = 16
    lprev = rng.integers(-1, CHUNK, (nc, CHUNK)).astype(np.int32)
    lnext = rng.integers(0, CHUNK + 1, (nc, CHUNK)).astype(np.int32)
    keyi = rng.integers(0, 600, (nc, CHUNK)).astype(np.int32)
    keyrow = rng.integers(0, 600, (nc, 256)).astype(np.int32)
    got = tmtf.ranks_from_parts_ref(
        *(torch.from_numpy(a) for a in (lprev, lnext, keyi, keyrow))
    )
    assert np.array_equal(got.numpy(), _tpubz_pallas_ranks(lprev, lnext, keyi, keyrow))


@pytest.mark.parametrize("case", ["random256", "near_periodic", "all256"])
def test_ranks_from_parts_ref_matches_pallas_real(case):
    """The plain version against tpubz's Pallas kernel on the real MTF parts
    of a block (the port's mtf_parts, whose ranks match tpubz above).
    Bit-exact (tolerance 0)."""
    c = CASES[case]
    _, hlast = bwt_encode(np.frombuffer(c, np.uint8))
    lprev, lnext, keyi, keyrow, _ = mtf_parts(torch.from_numpy(_pad(bytes(hlast))), len(c), CHUNK)
    got = tmtf.ranks_from_parts_ref(lprev, lnext, keyi, keyrow)
    exp = _tpubz_pallas_ranks(*(t.numpy() for t in (lprev, lnext, keyi, keyrow)))
    assert np.array_equal(got.numpy(), exp)


@pytest.mark.parametrize("case", CASE_IDS)
def test_mtf_rle2_chain_matches_tpubz_and_hostref(case):
    """MTF -> RLE2 on a last column: symbols, length and frequencies equal
    tpubz's chain and the host oracle's mtf_rle2_encode. Bit-exact."""
    c = CASES[case]
    n = len(c)
    _, hlast = bwt_encode(np.frombuffer(c, np.uint8))
    last = _pad(bytes(hlast))
    ranks, used = mtf_ranks(torch.from_numpy(last), n, CHUNK)
    syms, rle2_len, freqs = rle2_encode(ranks, n, used.sum() + 1)
    rl = int(rle2_len)
    jsyms, jrl, jfreqs = _jax_chain(jnp.asarray(last), jnp.int32(n))
    h_rle2, h_freqs, h_used = mtf_rle2_encode(hlast)
    assert rl == int(jrl) == h_rle2.size
    assert np.array_equal(syms.numpy()[:rl], np.asarray(jsyms)[:rl].astype(np.int32))
    assert np.array_equal(syms.numpy()[:rl], h_rle2.astype(np.int32))
    assert np.array_equal(freqs.numpy(), np.asarray(jfreqs).astype(np.int64))
    assert np.array_equal(freqs.numpy(), h_freqs.astype(np.int64))
    assert np.array_equal(used.numpy(), np.asarray(h_used, bool))


def test_all256_reaches_rank_255_and_symbol_256():
    """The edge the chain must carry: rank 255 becomes RLE2 symbol 256."""
    c = CASES["all256"]
    _, hlast = bwt_encode(np.frombuffer(c, np.uint8))
    ranks, used = mtf_ranks(torch.from_numpy(_pad(bytes(hlast))), len(c), CHUNK)
    syms, rle2_len, _ = rle2_encode(ranks, len(c), used.sum() + 1)
    assert int(ranks[: len(c)].max()) == 255
    assert syms.dtype == torch.uint16 and int(syms[: int(rle2_len) - 1].long().max()) == 256


def test_num_digits_matches_tpubz():
    """The integer floor(log2(L+1)) equals tpubz's clz form on every L
    below 2^20 (block runs are < 900,100) and at the top of int32."""
    L = np.concatenate((np.arange(-2, 1 << 20), [2**31 - 2, 2**30, 2**30 - 1])).astype(np.int32)
    got = num_digits(torch.from_numpy(L).to(torch.int64)).numpy()
    assert np.array_equal(got, np.asarray(jrle2.num_digits(jnp.asarray(L))))


def test_geometry_matches_tpubz():
    """The port declares the MTF chunk and the padded block length itself
    (tpubz.block.encode imports jax); they must equal tpubz's."""
    from tpubz.block import encode as jenc
    from tpubz_torch.block.encode import MTF_CHUNK, block_n

    assert MTF_CHUNK == jenc.MTF_CHUNK == tmtf.CHUNK
    for level in range(1, 10):
        assert block_n(level) == jenc.DeviceBlockEncoder(level).N
    assert block_n(9) == 900_096

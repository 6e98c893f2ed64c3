"""The port's batch functions (the multi-process path's transform) against
tpubz's on the CPU, tolerance 0 (the codec is integer).

Seeded numpy rows go through tpubz's batched stages on the JAX CPU backend
(the BWT as ``tpubz/dist/sharded.py`` runs it, ``jax.lax.map`` of
``bwt_forward(..., skip_converged="batch")``; ``mtf_ranks_batch`` with
``use_pallas=False``; ``rle2_encode_batch``; ``_stage_compact`` vmapped) and
through the port's plain versions, which the wrappers run for CPU tensors.
The rows cover a 1-byte pad dummy, periodic rows (tied rotations), all 256
byte values, lengths that are no multiple of 256, and a level-1 block whose
symbols >= 256 overflow the sidecar. The whole transform is held to tpubz's
``make_sharded_transform`` on a one-device mesh at B = 4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubz.block import encode as tenc
from tpubz.dist import sharded as tsharded
from tpubz.kernels import mtf as tmtf
from tpubz.kernels import rle2 as trle2
from tpubz.kernels.suffix_sort import bwt_forward as tbwt

from tpubz_torch.block.encode import HI_CAP, block_n, uncompact_syms
from tpubz_torch.corpus import sidecar_overflow_block
from tpubz_torch.dist.sharded import make_sharded_transform
from tpubz_torch.kernels import compact, mtf, rle2, suffix_sort

N = 4096


def _rows(names, width=N):
    """(data uint8[B, width], n int32[B]) of the named seeded rows."""
    rng = np.random.default_rng(2026)
    make = {
        "random_odd": lambda: rng.integers(0, 256, 4001, dtype=np.uint8),
        "periodic": lambda: np.frombuffer(b"abc" * 1000, np.uint8),
        "all256": lambda: np.tile(np.arange(256, dtype=np.uint8), width // 256),
        "pad": lambda: np.zeros(1, np.uint8),
        "few_symbols": lambda: rng.integers(0, 3, 2500, dtype=np.uint8),
        "near_periodic": lambda: np.frombuffer(b"ab" * 1500 + b"c", np.uint8),
    }
    data = np.zeros((len(names), width), np.uint8)
    n = np.zeros(len(names), np.int32)
    for b, name in enumerate(names):
        row = make[name]()
        data[b, : row.size] = row
        n[b] = row.size
    return data, n


ROW_SETS = {
    "mixed": ["random_odd", "periodic", "all256", "pad"],
    "one": ["few_symbols"],
    "three": ["near_periodic", "pad", "random_odd"],
}


@functools.lru_cache(maxsize=None)
def _tpubz_chain(rows):
    """tpubz's batched stages on the rows: (data, n, keys, last, ranks,
    used, syms, rle2_len, freqs), numpy."""
    data, n = _rows(list(rows))
    keys, last = jax.lax.map(lambda a: tbwt(a[0], a[1], skip_converged="batch"),
                             (jnp.asarray(data), jnp.asarray(n)))
    ranks, used = tmtf.mtf_ranks_batch(last, jnp.asarray(n), chunk=256, use_pallas=False)
    eob = jnp.sum(used, axis=1).astype(jnp.int32) + 1
    syms, rle2_len, freqs = trle2.rle2_encode_batch(ranks, jnp.asarray(n), eob)
    return tuple(np.array(x) for x in (data, n, keys, last, ranks, used, syms, rle2_len, freqs))


@pytest.mark.parametrize("rows", list(ROW_SETS))
def test_bwt_forward_batch_matches_tpubz(rows):
    """bwt_forward_batch on CPU tensors: every row's key and last column
    (pad lanes zero) equal tpubz's lax.map of bwt_forward, and each row
    equals the one-block bwt_forward."""
    data, n, keys, last, *_ = _tpubz_chain(tuple(ROW_SETS[rows]))
    got_keys, got_last = suffix_sort.bwt_forward_batch(torch.from_numpy(data), n.tolist())
    assert got_keys.dtype == torch.int64 and got_last.dtype == torch.uint8
    assert np.array_equal(got_keys.numpy(), keys.astype(np.int64))
    assert np.array_equal(got_last.numpy(), last)
    for b in range(len(n)):
        key, col = suffix_sort.bwt_forward(torch.from_numpy(data[b]), int(n[b]))
        assert int(key) == int(got_keys[b]) and torch.equal(col, got_last[b])


@pytest.mark.parametrize("rows", list(ROW_SETS))
def test_mtf_ranks_batch_matches_tpubz(rows):
    """mtf_ranks_batch on tpubz's last columns: the ranks of every valid
    lane and the used maps equal tpubz's mtf_ranks_batch (pad lanes are
    unspecified there, 0 here), given lengths as host ints or a tensor."""
    data, n, _, last, ranks, used, *_ = _tpubz_chain(tuple(ROW_SETS[rows]))
    for lengths in (n.tolist(), torch.from_numpy(n)):
        got_ranks, got_used = mtf.mtf_ranks_batch(torch.from_numpy(last), lengths)
        assert got_ranks.dtype == torch.int32 and got_used.dtype == torch.bool
        assert np.array_equal(got_used.numpy(), used)
        for b, nb in enumerate(n):
            assert np.array_equal(got_ranks[b, :nb].numpy(), ranks[b, :nb])
            assert not got_ranks[b, nb:].any()


@pytest.mark.parametrize("rows", list(ROW_SETS))
def test_rle2_encode_batch_matches_tpubz(rows):
    """rle2_encode_batch on tpubz's ranks: symbols (every slot, zero past
    the length), lengths and frequencies equal tpubz's rle2_encode_batch in
    its types."""
    _, n, _, _, ranks, used, syms, rle2_len, freqs = _tpubz_chain(tuple(ROW_SETS[rows]))
    eob = torch.from_numpy(used.sum(1).astype(np.int32) + 1)
    got = rle2.rle2_encode_batch(torch.from_numpy(ranks), n.tolist(), eob)
    assert [g.dtype for g in got] == [torch.uint16, torch.int32, torch.int32]
    assert np.array_equal(got[0].numpy(), syms)
    assert np.array_equal(got[1].numpy(), rle2_len)
    assert np.array_equal(got[2].numpy(), freqs)


def _overflow_syms():
    """Symbol rows whose symbols >= 256 overflow the sidecar, and one under
    it, with lengths short of the row (the contract's zeros past them)."""
    rng = np.random.default_rng(8)
    OUT = 20_008
    syms = rng.choice([0, 1, 5, 255, 256, 257], size=(3, OUT), p=[.2, .1, .05, .05, .4, .2])
    lens = np.array([OUT, 19_000, 700], np.int32)
    for b, ln in enumerate(lens):
        syms[b, ln:] = 0
    return syms.astype(np.uint16), lens


@pytest.mark.parametrize("case", ["chain_mixed", "chain_three", "overflow"])
def test_stage_compact_matches_tpubz(case):
    """stage_compact equals tpubz's _stage_compact vmapped over the rows:
    the low bytes, the sidecar in position order (entries past HI_CAP
    dropped, zero after the last) and the counts of every symbol >= 256."""
    if case == "overflow":
        syms, lens = _overflow_syms()
    else:
        *_, syms, lens, _ = _tpubz_chain(tuple(ROW_SETS[case.removeprefix("chain_")]))
    want = [np.asarray(x) for x in
            jax.vmap(tenc._stage_compact)(jnp.asarray(syms), jnp.asarray(lens))]
    got = compact.stage_compact(torch.from_numpy(syms), torch.from_numpy(lens))
    assert [g.dtype for g in got] == [torch.uint8, torch.int32, torch.int32]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    if case == "overflow":
        assert int(got[2].max()) > HI_CAP


def test_uncompact_syms_inverts_the_compact_form():
    """uncompact_syms rebuilds every symbol row whose sidecar did not
    overflow, as tpubz's uncompact_syms does; HI_CAP is tpubz's."""
    assert HI_CAP == tenc.HI_CAP == compact.HI_CAP
    syms, lens = _overflow_syms()
    *_, chain_syms, chain_lens, _ = _tpubz_chain(tuple(ROW_SETS["mixed"]))
    rows = [(syms[2], lens[2])] + list(zip(chain_syms, chain_lens))
    for s, ln in rows:
        u8, hip, hc = (x[0].numpy() for x in compact.stage_compact(
            torch.from_numpy(s[None].copy()), torch.tensor([ln], dtype=torch.int32)))
        assert int(hc) <= HI_CAP
        back = uncompact_syms(u8, hip, int(hc))
        assert np.array_equal(back[:ln], s[:ln])
        assert np.array_equal(back, tenc.uncompact_syms(u8, hip, int(hc)))


def test_stage_compact_rejects_what_it_does_not_take():
    syms = torch.zeros(2, 64, dtype=torch.uint16)
    with pytest.raises(TypeError):
        compact.stage_compact(syms.int(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        compact.stage_compact(syms, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        compact.stage_compact(syms, torch.zeros(2, dtype=torch.int64))


def test_batch_wrappers_reject_bad_lengths():
    data = torch.zeros(2, 512, dtype=torch.uint8)
    with pytest.raises(ValueError):
        suffix_sort.bwt_forward_batch(data, [3])
    with pytest.raises(ValueError):
        suffix_sort.bwt_forward_batch(data, [3, 513])
    with pytest.raises(TypeError):
        suffix_sort.bwt_forward_batch(data[:, ::2], [3, 3])
    with pytest.raises(ValueError):
        mtf.mtf_ranks_batch(data, [3, 600])
    with pytest.raises(ValueError):
        rle2.rle2_encode_batch(torch.zeros(2, 512, dtype=torch.int32), [3, 3], [1, 2, 3])


@functools.lru_cache(maxsize=1)
def _level1_rows():
    """Four level-1 rows: the sidecar overflow block, a periodic row, random
    bytes of an odd length and a 1-byte pad dummy."""
    width = block_n(1)
    data = np.zeros((4, width), np.uint8)
    over = np.frombuffer(sidecar_overflow_block(100_000), np.uint8)
    periodic = np.frombuffer(b"abc" * 1666 + b"ab", np.uint8)
    rand = np.random.default_rng(31).integers(0, 256, 99_999, dtype=np.uint8)
    for b, row in enumerate((over, periodic, rand)):
        data[b, : row.size] = row
    n = np.array([over.size, periodic.size, rand.size, 1], np.int32)
    return data, n


@functools.lru_cache(maxsize=1)
def _tpubz_transform():
    data, n = _level1_rows()
    fn, _ = tsharded.make_sharded_transform(tsharded.block_mesh(jax.devices()[:1]), data.shape[1])
    return tuple(np.array(x) for x in fn(jnp.asarray(data), jnp.asarray(n)))


_OUTPUTS = ["keys", "syms", "rle2_len", "freqs", "used", "syms_u8", "hi_packed", "hi_count"]


@pytest.mark.parametrize("output", _OUTPUTS)
def test_sharded_transform_matches_tpubz_level1(output):
    """make_sharded_transform(device="cpu") at level 1 and B = 4 gives each
    of tpubz's eight outputs (its make_sharded_transform on a one-device
    mesh), every lane; the overflow row's count exceeds HI_CAP."""
    data, n = _level1_rows()
    got = _port_transform()
    want = _tpubz_transform()
    k = _OUTPUTS.index(output)
    assert np.array_equal(got[k].numpy().astype(np.int64), want[k].astype(np.int64))
    assert got[k].shape == want[k].shape
    if output == "hi_count":
        assert int(got[k][0]) > HI_CAP and int(got[k][1]) <= HI_CAP


@functools.lru_cache(maxsize=1)
def _port_transform():
    data, n = _level1_rows()
    return make_sharded_transform("cpu", data.shape[1])(torch.from_numpy(data), n.tolist())


def test_sharded_transform_rejects_other_widths():
    fn = make_sharded_transform("cpu", 512)
    with pytest.raises(ValueError):
        fn(torch.zeros(2, 256, dtype=torch.uint8), [1, 1])
    with pytest.raises(ValueError):
        make_sharded_transform("cpu", 500)
    with pytest.raises(ValueError):
        make_sharded_transform("meta", 512)

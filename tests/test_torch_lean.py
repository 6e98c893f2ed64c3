"""The port's lean transfer form against tpubz's, on the CPU, tolerance 0.

``kernels/compact.py:rle2_compact`` (its plain version, which the wrapper
runs for CPU tensors) against ``tpubz/block/encode.py:_rle2_compact`` on the
port's MTF ranks of seeded blocks at N = 4096: random bytes, every byte
value in order (symbol 256 in the body and an EOB of 257), one run, one
byte, no byte; and on synthetic ranks at N = 16,384 with more rank-255
literals than the sidecar holds (``HI_CAP``). Below ``HI_CAP`` lanes
tpubz's function runs eagerly: under jit its ``lax.cond`` would need both
branches of one shape, and its sorted branch has only N + 8 entries, which
are then held to the port's first N + 8 (the rest must be 1 << 30).

Then the lean chain of ``DeviceBlockEncoder`` at level 1: ``fetch`` of
``transform(blk, lean=True)`` equals ``fetch`` of the int16 form field by
field, and both equal tpubz's ``materialize`` of tpubz's own lean 7-tuple
(``_stage_bwt``, ``_stage_mtf``, ``_stage_rle2c``) and of its full tuple
(``_stage_post``); a block of 49,860 symbols >= 256 takes the full-row
fetch. ``encode_block``, which takes the lean chain, gives the bits of
tpubz's native engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubz.block import encode as tenc
from tpubz.stream import api as tapi

from tpubz_torch.block.encode import HI_CAP, DeviceBlockEncoder, block_n
from tpubz_torch.corpus import sidecar_overflow_block
from tpubz_torch.kernels import compact, mtf
from tpubz_torch.kernels.suffix_sort import bwt_forward

from torch_native_guard import tpubz_native  # noqa: F401 (a fixture)

torch.set_num_threads(2)

N = 4096


def _mtf_of(block: np.ndarray, width: int = N):
    """The port's MTF (ranks int32[width], used bool[256]) of the block's
    BWT on the CPU."""
    pad = torch.zeros(width, dtype=torch.uint8)
    pad[: block.size] = torch.from_numpy(block)
    _, last = bwt_forward(pad, block.size)
    return mtf.mtf_ranks(last, block.size)


def _overflow_ranks():
    """Synthetic ranks at N = 16,384: rank 255 on 9,000 of the first
    15,000 lanes, zero runs of 1 to 3 between them, all 256 bytes used."""
    rng = np.random.default_rng(2026)
    r = np.zeros(4 * N, np.int32)
    lanes = np.sort(rng.choice(15_000, 9_000, replace=False))
    r[lanes] = 255
    r[rng.choice(15_000, 500)] = rng.integers(1, 255, 500)
    return torch.from_numpy(r), 15_500, torch.ones(256, dtype=torch.bool)


CASES = {
    "random": lambda: (*_mtf_of(np.random.default_rng(7).integers(0, 256, 4000, dtype=np.uint8)),
                       4000),
    "all256": lambda: (*_mtf_of(np.tile(np.arange(256, dtype=np.uint8), N // 256)), N),
    "run": lambda: (*_mtf_of(np.full(4000, 9, np.uint8)), 4000),
    "one_byte": lambda: (*_mtf_of(np.array([200], np.uint8)), 1),
    "empty": lambda: (*_mtf_of(np.zeros(0, np.uint8)), 0),
}


def _case(name):
    """(ranks int32[width], n, used bool[256])."""
    if name == "overflow":
        return _overflow_ranks()
    ranks, used, n = CASES[name]()
    return ranks, n, used


def _tpubz_compact(ranks, n, used):
    """tpubz's _rle2_compact on the same inputs, as numpy."""
    args = (jnp.asarray(ranks.numpy()), jnp.int32(n), jnp.asarray(used.numpy()))
    if ranks.shape[0] + 8 >= tenc.HI_CAP:
        out = jax.jit(tenc._rle2_compact)(*args)
    else:
        with jax.disable_jit():
            out = tenc._rle2_compact(*args)
    rl, quarters, hi_pos, hc, syms = out
    return (int(rl), np.concatenate([np.asarray(q) for q in quarters]), np.asarray(hi_pos),
            int(hc), np.asarray(syms))


@pytest.mark.parametrize("case", [*CASES, "overflow"])
def test_rle2_compact_matches_tpubz(case):
    """rle2_compact on CPU tensors equals tpubz's _rle2_compact: the length,
    the byte stream (its four quarters end to end), the ascending slots of
    the symbols 256, their count and the full symbol row."""
    ranks, n, used = _case(case)
    rl, u8, hi_pos, hc, syms = compact.rle2_compact(ranks, n, used)
    t_rl, t_u8, t_hi, t_hc, t_syms = _tpubz_compact(ranks, n, used)
    W = ranks.shape[0] + 8
    assert u8.dtype == torch.uint8 and u8.shape == (W,) and W % 4 == 0
    assert hi_pos.dtype == torch.int32 and hi_pos.shape == (HI_CAP,)
    assert syms.dtype == torch.uint16 and syms.shape == (W,)
    assert int(rl) == t_rl and int(hc) == t_hc
    assert np.array_equal(u8.numpy(), t_u8)
    assert np.array_equal(hi_pos.numpy()[: t_hi.size], t_hi)
    assert (hi_pos.numpy()[t_hi.size:] == compact.HI_NONE).all()
    assert np.array_equal(syms.numpy(), t_syms.astype(np.int32))
    s = syms.numpy()
    if case == "all256":  # the EOB is 257 and clamps to 255; the body has 256
        assert s[t_rl - 1] == 257 and u8[t_rl - 1] == 255 and t_hc > 0
        assert t_hc == int((s[: t_rl - 1] == 256).sum())
    if case == "overflow":
        assert t_hc > HI_CAP and (hi_pos.numpy() < compact.HI_NONE).all()
        assert np.array_equal(hi_pos.numpy(), np.flatnonzero(s[: t_rl - 1] == 256)[:HI_CAP])


def test_block_n_keeps_the_quarters_whole():
    """N + 8 is a multiple of 4 at every level, so tpubz's reshape(4, -1)
    of the byte stream is exact (900,104 bytes at level 9)."""
    for level in range(1, 10):
        assert (block_n(level) + 8) % 4 == 0
    assert block_n(9) + 8 == 900_104


def _fetch_blocks():
    rng = np.random.default_rng(11)
    return {
        "text": b"the quick brown fox jumps over the lazy dog\n" * 2000,
        "random": rng.integers(0, 256, 60_000, dtype=np.uint8).tobytes(),
        "all256": bytes(range(256)) * 300,
        "run": b"z" * 5000,
        "one_byte": b"q",
        "overflow": sidecar_overflow_block(100_000),
    }


def _tpubz_materialize(blk: np.ndarray, lean: bool):
    """tpubz's materialize of its own lean 7-tuple or full tuple of the
    block at level 1."""
    pad = np.zeros(block_n(1), np.uint8)
    pad[: blk.size] = blk
    n = jnp.int32(blk.size)
    key, last = tenc._stage_bwt(jnp.asarray(pad), n)
    if lean:
        ranks, used = tenc._stage_mtf(last, n)
        rl, quarters, hi_pos, hc, syms = tenc._stage_rle2c(ranks, n, used)
        return tenc.materialize((key, syms, rl, used, quarters, hi_pos, hc))
    return tenc.materialize((key, *tenc._stage_post(last, n)))


@pytest.mark.parametrize("name", list(_fetch_blocks()))
def test_lean_fetch_matches_int16_fetch_and_materialize(name, tpubz_native):
    """The lean fetch equals the int16 fetch field by field (key, symbols
    and their type, length, frequencies, used map) and tpubz's materialize
    of both its forms; encode_block (the lean chain) gives the bits of
    tpubz's native engine."""
    blk = np.frombuffer(_fetch_blocks()[name], np.uint8)
    enc = DeviceBlockEncoder(1, "cpu")
    before = compact.LEAN_LAUNCHES
    out = enc.transform(blk, lean=True)
    assert len(out) == 7 and compact.LEAN_LAUNCHES == before  # CPU calls are not counted
    lean = enc.fetch(out)
    full = enc.fetch(enc.transform(blk))
    key, syms, rl, freqs, used = lean
    assert syms.dtype == np.uint16 and syms.size == rl and freqs.dtype == np.int64
    assert key == full[0] and rl == full[2]
    for a, b in zip((lean[1], lean[3], lean[4]), (full[1], full[3], full[4])):
        assert np.array_equal(a, b)
    for form in (True, False):
        t_key, t_syms, t_rl, t_freqs, t_used = _tpubz_materialize(blk, form)
        assert key == t_key and rl == t_rl
        assert np.array_equal(syms, np.asarray(t_syms)[:t_rl])
        assert np.array_equal(freqs, np.asarray(t_freqs).astype(np.int64))
        assert np.array_equal(used, np.asarray(t_used))
    hc = int(out[6])
    assert (hc > HI_CAP) == (name == "overflow")
    crc = 0x5A5A1234
    assert (enc.encode_block(blk, crc).pack()
            == tapi._HostFallbackEncoder(1).encode_block(blk, crc).pack())


def test_rle2_compact_rejects_what_it_does_not_take():
    ranks = torch.zeros(N, dtype=torch.int32)
    with pytest.raises(TypeError):
        compact.rle2_compact(ranks, 10, torch.zeros(256, dtype=torch.int32))
    with pytest.raises(TypeError):
        compact.rle2_compact(ranks, 10, torch.zeros(255, dtype=torch.bool))


def test_stage_probe_lean_mode_runs_at_level_1_on_cpu(monkeypatch):
    """stage_probe's lean mode on the CPU at level 1: streams of both forms
    in turns (the lean turns through rle2_compact, the encoder's transform
    restored after), and per block the fetch of each form and the two ways
    to copy the byte stream."""
    from tpubz_torch import stage_probe

    d = b"the quick brown fox jumps over the lazy dog\n" * 3000 + bytes(range(256)) * 400
    plain, calls = compact.rle2_compact_ref, []
    monkeypatch.setattr(compact, "rle2_compact_ref",
                        lambda *a: calls.append(1) or plain(*a))
    saved = DeviceBlockEncoder.transform
    turns = stage_probe.lean_turns(d, 1, "cpu", reps=1)
    assert DeviceBlockEncoder.transform is saved
    # one warm-up and two timed lean streams of the data's level-1 blocks
    assert len(calls) == 3 * len(list(stage_probe._blocks(d, 1)))
    assert [len(turns["MBps"][k]) for k in ("int16", "lean")] == [2, 2]
    assert min(turns["median_MBps"].values()) > 0
    costs = stage_probe.lean_fetch_costs(d, 1, "cpu")
    assert costs["blocks_timed"] >= 1
    assert set(costs["median_ms"]) == {"fetch_int16", "fetch_lean", "whole_stream",
                                       "prefix_after_scalars"}

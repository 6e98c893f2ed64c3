"""The port's device refine block encoder on the CPU, against the port's host
emission and tpubz's device refine encoder, byte for byte.

``DeviceBlockEncoder(1, device="cpu").encode_block_devrefine`` runs the
refinement's passes and the payload's packing through the plain versions of
the kernels on the port's ``transform`` output; its bytes must equal
``emit_block``'s (the native refinement and packing) on the fetched result,
and tpubz's ``DeviceBlockEncoder(1).encode_block_devrefine`` fed the same
tuple as JAX arrays, with tpubz's histogram in trans_out[8] built by its
own ``chunk_hist`` (so tpubz's BWT never compiles). The inputs: random
bytes, a period of 4, six symbols, every byte value in order (symbols >= 256)
and one byte. A payload whose bit count on the device differs from the
refinement's raises.
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubz.block.encode import DeviceBlockEncoder as TpubzEncoder
from tpubz.hostref.bitio import pack_bits as tpubz_pack_bits
from tpubz.kernels.huffman_dev import chunk_hist as tpubz_chunk_hist

from tpubz_torch.block import encode
from tpubz_torch.block.encode import DeviceBlockEncoder
from tpubz_torch.kernels import huffman_dev

from torch_native_guard import tpubz_native  # noqa: F401 (a fixture)

CRC = 0x12345678


def _blocks():
    rng = np.random.default_rng(2026)
    return {
        "random": rng.integers(0, 256, 50_000, dtype=np.uint8),
        "abcd": np.frombuffer(b"abcd" * 20_000, np.uint8),
        "six_symbols": rng.integers(0, 6, 99_000, dtype=np.uint8),
        "all256": np.tile(np.arange(256, dtype=np.uint8), 300),
        "one_byte": np.frombuffer(b"x", np.uint8),
    }


@functools.lru_cache(maxsize=None)
def _transformed(name):
    """The port's transform of the named block on the CPU (once a process)."""
    return DeviceBlockEncoder(1, device="cpu").transform(_blocks()[name])


@pytest.mark.parametrize("name", list(_blocks()))
def test_devrefine_matches_emit_block(name, tpubz_native):
    enc = DeviceBlockEncoder(1, device="cpu")
    out = _transformed(name)
    got = enc.encode_block_devrefine(out, CRC).pack()
    want = enc.emit_block(*enc.fetch(out), CRC).pack()
    assert got == want


@pytest.mark.parametrize("name", list(_blocks()))
def test_devrefine_matches_tpubz(name, tpubz_native):
    """The same bits as tpubz's encoder on the same transform output."""
    out = _transformed(name)
    key, syms, rle2_len, freqs, used = out
    syms16 = jnp.asarray(syms.numpy().astype(np.uint16))
    n = jnp.int32(int(rle2_len))
    trans = (jnp.asarray(int(key)), syms16, n, jnp.asarray(freqs.numpy()),
             jnp.asarray(used.numpy()), None, None, None, tpubz_chunk_hist(syms16, n))
    want = TpubzEncoder(1).encode_block_devrefine(trans, CRC)
    got = DeviceBlockEncoder(1, device="cpu").encode_block_devrefine(out, CRC)
    assert got.pack() == (tpubz_pack_bits(*want.arrays()), want.bit_len)


def test_devrefine_takes_a_batch_row_and_its_histogram(tpubz_native):
    """A row of the batch types (uint16 symbols, int32 length and
    frequencies) with its histogram from chunk_hist_batch gives the
    one-block bytes."""
    enc = DeviceBlockEncoder(1, device="cpu")
    key, syms, rle2_len, freqs, used = _transformed("all256")
    rows = torch.stack([syms, syms]).to(torch.uint16)
    lengths = torch.stack([rle2_len, rle2_len]).to(torch.int32)
    hist = huffman_dev.chunk_hist_batch(rows, lengths)
    row = (key, rows[1], lengths[1], freqs.to(torch.int32), used)
    got = enc.encode_block_devrefine(row, CRC, hist=hist[1]).pack()
    assert got == enc.emit_block(*enc.fetch(_transformed("all256")), CRC).pack()


def test_devrefine_raises_on_a_wrong_bit_count(monkeypatch, tpubz_native):
    """No host fallback: a device total that is not the refinement's count
    raises, naming both."""
    def off_by_one(*args):
        words, total = huffman_dev.pack_payload(*args)
        return words, total + 1

    monkeypatch.setattr(encode, "pack_payload", off_by_one)
    enc = DeviceBlockEncoder(1, device="cpu")
    out = _transformed("random")
    block_bits = enc.emit_block(*enc.fetch(out), CRC).pack()[1]
    with pytest.raises(RuntimeError) as e:
        enc.encode_block_devrefine(out, CRC)
    found = re.search(r"has (\d+) bits, the refinement counted (\d+)", str(e.value))
    total, counted = int(found[1]), int(found[2])
    assert total == counted + 1 and 0 < counted < block_bits


def test_stage_probe_devrefine_runs_at_level_1_on_cpu(tpubz_native):
    """The probe's device refine anatomy at level 1 with the plain versions:
    every block timed, a profile of the calls."""
    from tpubz_torch import stage_probe

    d = bytes(np.random.default_rng(5).integers(0, 8, 150_000, dtype=np.uint8))
    out = stage_probe.devrefine_anatomy(d, 1, "cpu", top=5)
    assert out["blocks"] == 2 and len(out["top_own_time"]) == 5
    assert out["ms_per_block"]["min"] > 0 and out["profiled_ms_per_block_median"] > 0
    assert any("encode_block_devrefine" in r["function"] for r in
               stage_probe.devrefine_anatomy(d, 1, "cpu", top=1000)["top_own_time"])

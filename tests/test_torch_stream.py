"""The port's block encoder and stream API against tpubz's, on the CPU.

Level 1 with about 260 KB, which RLE1 cuts into 3 blocks. The codec is
integer, so every comparison is byte-exact (tolerance 0).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from tpubz.format.constants import block_budget
from tpubz.format.crc import block_crc
from tpubz.hostref.rle1 import rle1_blocks
from tpubz.stream import api as tapi

import tpubz_torch
from tpubz_torch.block.encode import DeviceBlockEncoder
from tpubz_torch.stream import api as papi

from torch_native_guard import tpubz_native  # noqa: F401 (a fixture)

# the test workers share the host's cores: keep torch's intra-op pool small
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def port_profile(tmp_path, monkeypatch):
    """The port's rig profile, trained by every device stream, in a fresh
    TPUBZ_TORCH_CACHE per test."""
    from tpubz_torch.stream import rigprofile

    monkeypatch.setenv("TPUBZ_TORCH_CACHE", str(tmp_path / "torch_cache"))
    rigprofile.reset_memo()
    yield
    rigprofile.reset_memo()


def _data() -> bytes:
    rng = np.random.default_rng(7)
    return (
        b"the quick brown fox jumps over the lazy dog\n" * 1500
        + bytes(rng.integers(0, 256, 60_000, dtype=np.uint8))
        + b"ab" * 40_000
        + b"c"
        + bytes(range(256)) * 100
        + b"z" * 5000
        + bytes(rng.integers(0, 8, 30_000, dtype=np.uint8))
    )


@pytest.fixture(scope="module")
def data():
    d = _data()
    assert 250_000 < len(d) < 270_000
    return d


def test_block_bytes_match_tpubz(data):
    """Each block's bits from DeviceBlockEncoder(1, "cpu") equal tpubz's
    device encoder (JAX on the CPU backend) and the native CPU engine."""
    from tpubz.block.encode import DeviceBlockEncoder as JaxEncoder

    arr = np.frombuffer(data, np.uint8)
    out, blocks = rle1_blocks(arr, block_budget(1))
    assert len(blocks) == 3
    enc = DeviceBlockEncoder(1, "cpu")
    jenc = JaxEncoder(1)
    host = tapi._HostFallbackEncoder(1)
    for o0, o1, i0, i1 in blocks:
        blk, crc = out[o0:o1], block_crc(arr[i0:i1])
        got = enc.encode_block(blk, crc).pack()
        assert got == jenc.encode_block(blk, crc).pack()
        assert got == host.encode_block(blk, crc).pack()


def test_fetch_matches_native_transform(data, tpubz_native):
    """fetch(transform(blk)) is tpubz's materialize tuple: key, symbols,
    frequencies and used map equal the native engine's, EOB last."""
    block_transform_native = tpubz_native.block_transform_native
    arr = np.frombuffer(data, np.uint8)
    out, blocks = rle1_blocks(arr, block_budget(1))
    enc = DeviceBlockEncoder(1, "cpu")
    assert enc.level == 1 and enc.N == 100_096
    for o0, o1, _, _ in blocks:
        blk = out[o0:o1]
        key, syms, rl, freqs, used = enc.fetch(enc.transform(blk))
        nkey, nsyms, nfreqs, nused = block_transform_native(blk)
        assert key == nkey and rl == nsyms.size
        assert syms.dtype == np.uint16 and np.array_equal(syms, nsyms)
        assert np.array_equal(freqs, nfreqs.astype(np.int64))
        assert np.array_equal(used, nused)
        assert syms[-1] == used.sum() + 1


def test_compress_matches_tpubz(data, monkeypatch, sys_bunzip2):
    """tpubz_torch.compress(d, 1, device="cpu") equals tpubz's device path
    (forced on for a short stream), compress_cpu, and round-trips through
    the port's decompress and the system bunzip2."""
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    got = tpubz_torch.compress(data, 1, device="cpu")
    assert papi.last_stream_stats["blocks"] == 3
    assert got == tapi.compress(data, 1)
    assert tapi.last_stream_stats["dev_blocks"] == 3
    assert got == tapi.compress_cpu(data, 1)
    assert tpubz_torch.decompress(got) == data
    assert sys_bunzip2(got) == data


def test_compress_feed_path_and_window(monkeypatch):
    """A stream above four block budgets takes the background RLE1 feed;
    a window of 2 drains while blocks are in flight. Bytes equal
    compress_cpu."""
    rng = np.random.default_rng(11)
    d = bytes(rng.integers(0, 3, 420_000, dtype=np.uint8))
    monkeypatch.setattr(papi, "WINDOW", 2)
    got = tpubz_torch.compress(d, 1, device="cpu")
    assert papi.last_stream_stats["blocks"] == 5
    assert got == tapi.compress_cpu(d, 1)


@pytest.mark.parametrize("d", [b"", b"x", b"\x00" * 1000], ids=["empty", "x", "zeros"])
def test_compress_tiny_inputs(d):
    """Empty and one-block inputs equal compress_cpu and round-trip."""
    got = tpubz_torch.compress(d, 9, device="cpu")
    assert got == tapi.compress_cpu(d, 9)
    assert tpubz_torch.decompress(got) == d


def test_mixed_corpus_is_a_function_of_its_seed():
    """The smoke run's corpus: the same seed gives the same bytes, another
    seed other bytes, and the size asked for."""
    from tpubz_torch.corpus import mixed_corpus

    a = mixed_corpus(2, 3)
    assert len(a) == 2 << 20
    assert a == mixed_corpus(2, 3)
    assert a != mixed_corpus(2, 4)


def test_cuda_without_card_raises(monkeypatch):
    """The device is explicit: "cuda" with no usable card raises instead of
    carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpubz_torch.compress(b"hello", 9)
    with pytest.raises(RuntimeError):
        DeviceBlockEncoder(9, "cuda")
    with pytest.raises(ValueError):
        tpubz_torch.compress(b"hello", 0, device="cpu")


def test_port_never_imports_jax(tmp_path):
    """A process that imports tpubz_torch and drives compress, open,
    BZ2Compressor and the command line holds no jax."""
    code = (
        "import io, os, sys, tpubz_torch\n"
        "from tpubz_torch import cli\n"
        "d = bytes(range(256)) * 50\n"
        "assert tpubz_torch.decompress(tpubz_torch.compress(d, 1, device='cpu')) == d\n"
        "buf = io.BytesIO()\n"
        "with tpubz_torch.open(buf, 'wb', device='cpu') as f:\n"
        "    f.write(d)\n"
        "assert tpubz_torch.decompress(buf.getvalue()) == d\n"
        "c = tpubz_torch.BZ2Compressor(1, device='cpu')\n"
        "assert tpubz_torch.decompress(c.compress(d) + c.flush()) == d\n"
        "p = os.path.join(os.environ['TPUBZ_TORCH_CACHE'], 'in.txt')\n"
        "open(p, 'wb').write(d)\n"
        "assert cli.run(['-1', p], device='cpu') == 0\n"
        "assert tpubz_torch.decompress(open(p + '.bz2', 'rb').read()) == d\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, TPUBZ_TORCH_CACHE=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_device_error_propagates_without_fallback(data, monkeypatch):
    """A failing device transform fails the stream instead of the block
    being redone on the CPU, and the pipeline's threads are gone after."""
    import threading

    calls = []

    def flaky_of(real):
        def flaky(self, blk):
            calls.append(blk.size)
            if len(calls) == 2:
                raise RuntimeError("device fault")
            return real(self, blk)
        return flaky

    # the stage is picked by the profile: inject into both
    for name in ("transform", "transform_bwt"):
        monkeypatch.setattr(DeviceBlockEncoder, name, flaky_of(getattr(DeviceBlockEncoder, name)))
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="device fault"):
        tpubz_torch.compress(data, 1, device="cpu")
    assert [t for t in threading.enumerate() if t not in before] == []


def test_stage_probe_runs_at_level_1_on_cpu():
    """The stage probe's phases, at a small size with the plain versions:
    every block is timed, the stages add up, and the window sweep restores
    the pipeline's window."""
    from tpubz_torch import stage_probe

    d = _data()
    st = stage_probe.stage_times(d, 1, "cpu")
    assert st["blocks_timed"] == 2
    med = st["median_ms"]
    parts = ("upload", "bwt", "mtf", "rle2", "fetch")
    assert all(med[k] >= 0 for k in parts) and med["native_emit"] > 0
    assert st["sum_ms"]["dispatcher_total"] == pytest.approx(
        sum(st["sum_ms"][k] for k in parts))
    prof = stage_probe.profile_stream(d, 1, "cpu")
    assert prof["device_events"] == 0 and prof["idle_share"] is None
    assert prof["bwt_kernels"] == []
    sweep = stage_probe.window_sweep(d, 1, "cpu", reps=1)
    assert set(sweep["MBps"]) == {str(w) for w in stage_probe.WINDOWS}
    assert len(sweep["host_engine_MBps"]) == 1
    assert papi.WINDOW == sweep["default"]


def test_bwt_kernel_times_fold_template_arguments():
    """bwt_anatomy's sums by kernel: the radix passes under one name, with
    or without template arguments or parameters in their symbol, and every
    other BWT kernel under its own name; other kernels as named."""
    from tpubz_torch.stage_probe import BWT_KERNELS, _by_kernel

    passes = ("void tpubz::radix::(anonymous namespace)::radix_pass("
              "tpubz::radix::(anonymous namespace)::PassArgs)")
    call = {"kernels_us": {passes: 3.0,
                           "void tpubz::radix::(anonymous namespace)::radix_pass<8>(...)": 4.0,
                           "void (anonymous namespace)::bwt_keys<8>(...)": 2.0,
                           "Memset (Device)": 0.5},
            "kernels_launches": {passes: 5,
                                 "void tpubz::radix::(anonymous namespace)::radix_pass<8>(...)": 4,
                                 "void (anonymous namespace)::bwt_keys<8>(...)": 1,
                                 "Memset (Device)": 1}}
    out = _by_kernel(call)
    assert out["radix_pass"] == {"us": 7.0, "launches": 9}
    assert out["bwt_keys"] == {"us": 2.0, "launches": 1}
    assert out["Memset (Device)"] == {"us": 0.5, "launches": 1}
    assert "bwt_rank_apply" in BWT_KERNELS and "bwt_last_column" in BWT_KERNELS


def test_union_of_device_intervals():
    from tpubz_torch.stage_probe import _union_us

    assert _union_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert _union_us([]) == 0

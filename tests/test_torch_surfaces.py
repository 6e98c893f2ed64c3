"""The port's file, incremental and command-line surfaces, on the CPU.

Subsets of tpubz's ``tests/test_fileobj.py``, ``tests/test_incremental.py``
and ``tests/test_cli_files.py`` on ``tpubz_torch`` with ``device="cpu"``,
checked against the stdlib ``bz2`` and, byte for byte (tolerance 0),
against ``tpubz.stream.api.compress_cpu``. ``TPUBZ_MIN_DEVICE_BLOCKS=1``
puts even one-block streams on the device path (the kernels' plain torch
versions). Inputs are made with numpy from a seed, at a few tens of KB.
Every call that starts threads runs under a 60 s bound.
"""
import bz2
import io
import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import torch

from tpubz.stream.api import compress_cpu

import tpubz_torch
from tpubz_torch import cli
from tpubz_torch.stream import api as papi
from tpubz_torch.stream import rigprofile

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_S = 60.0


def bounded(fn, *args, **kwargs):
    """fn(*args, **kwargs) on a daemon thread; fails the test after 60 s."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(BOUND_S)
    if t.is_alive():
        pytest.fail(f"{getattr(fn, '__name__', fn)} still running after {BOUND_S} s")
    if "error" in box:
        raise box["error"]
    return box["value"]


@pytest.fixture(autouse=True)
def device_path(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUBZ_TORCH_CACHE", str(tmp_path / "torch_cache"))
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    rigprofile.reset_memo()
    yield
    rigprofile.reset_memo()


def _payload(seed: int, n: int = 40_000) -> bytes:
    rng = np.random.default_rng(seed)
    return (
        bytes(rng.integers(0, 200, n // 2, dtype=np.uint8))
        + b"spam" * (n // 8)
        + bytes(rng.integers(0, 6, n // 4, dtype=np.uint8))
    )


def test_open_write_then_stdlib_reads(tmp_path):
    """Incremental writes of awkward sizes; the file is compress_cpu's
    stream and bz2 reads it."""
    d = _payload(1)
    p = tmp_path / "a.bz2"

    def write():
        with tpubz_torch.open(p, "wb", compresslevel=7, device="cpu") as f:
            for off in range(0, len(d), 12_347):
                assert f.write(d[off:off + 12_347]) == len(d[off:off + 12_347])
            assert f.tell() == len(d)

    bounded(write)
    assert papi.last_stream_stats["dev_blocks"] == 1
    assert p.read_bytes() == compress_cpu(d, 7)
    assert bz2.open(p, "rb").read() == d


def test_open_append_concatenates(tmp_path):
    p = tmp_path / "d.bz2"

    def write():
        with tpubz_torch.open(p, "wb", device="cpu") as f:
            f.write(b"hello ")
        with tpubz_torch.open(p, "ab", device="cpu") as f:
            f.write(b"world")

    bounded(write)
    with tpubz_torch.open(p, "rb") as f:
        assert f.read() == b"hello world"
    assert bz2.open(p, "rb").read() == b"hello world"


def test_open_text_mode(tmp_path):
    p = tmp_path / "e.bz2"

    def write():
        with tpubz_torch.open(p, "wt", encoding="utf-8", device="cpu") as f:
            f.write("héllo\nwörld\n")

    bounded(write)
    with tpubz_torch.open(p, "rt", encoding="utf-8") as f:
        assert f.read() == "héllo\nwörld\n"


def test_open_fileobj_target_and_bz2file_alias():
    d = _payload(2, 30_000)
    buf = io.BytesIO()

    def write():
        with tpubz_torch.BZ2File(buf, "wb", device="cpu") as f:
            f.write(d)
        return buf.getvalue()

    z = bounded(write)
    assert z == compress_cpu(d, 9)
    assert bz2.decompress(z) == d
    with tpubz_torch.open(io.BytesIO(z), "rb") as f:
        assert f.read() == d
    with pytest.raises(io.UnsupportedOperation):
        with tpubz_torch.open(io.BytesIO(), "wb", device="cpu") as f:
            f.read()


def test_compressor_chunked_equals_compress():
    """BZ2Compressor fed in uneven chunks gives compress_cpu's stream."""
    d = _payload(3, 60_000)
    rng = np.random.default_rng(3)

    def feed():
        c = tpubz_torch.BZ2Compressor(9, device="cpu")
        out, i = [], 0
        while i < len(d):
            step = int(rng.integers(1, 9_000))
            out.append(c.compress(d[i:i + step]))
            i += step
        out.append(c.flush())
        return b"".join(out)

    blob = bounded(feed)
    assert blob == compress_cpu(d, 9)
    assert bz2.decompress(blob) == d


def test_compressor_empty_stream_and_use_after_flush():
    c = tpubz_torch.BZ2Compressor(9, device="cpu")
    blob = bounded(c.flush)
    assert len(blob) == 14 and bz2.decompress(blob) == b""
    with pytest.raises(ValueError):
        c.compress(b"more")
    with pytest.raises(ValueError):
        c.flush()


def test_decompressor_is_tpubz_and_reads_stdlib_streams():
    """The port's own BZ2Decompressor gives tpubz's outputs, state and
    errors on the same chunked feeds: its own and C bzip2's (stdlib)
    streams, trailing bytes, max_length, and a corrupt block."""
    from tpubz.incremental import BZ2Decompressor as TpubzDecompressor

    assert tpubz_torch.BZ2Decompressor.__module__ == "tpubz_torch.incremental"
    d = _payload(4, 200_000)
    streams = {
        "c_stream": bz2.compress(d, 1) + b"tail",
        "own_stream": compress_cpu(d, 1) + b"tail",
    }
    corrupt = bytearray(streams["c_stream"])
    corrupt[len(corrupt) // 2] ^= 0x10
    streams["corrupt"] = bytes(corrupt)
    rng = np.random.default_rng(4)

    def feed(cls, blob, cuts, max_length):
        dec, outs = cls(), []
        try:
            prev = 0
            for cut in cuts + [len(blob)]:
                outs.append(dec.decompress(blob[prev:cut], max_length))
                prev = cut
                while not dec.eof and not dec.needs_input:
                    outs.append(dec.decompress(b"", max_length))
        except (ValueError, EOFError) as e:
            outs.append(type(e))
        return outs, dec.eof, dec.unused_data, dec.needs_input

    for name, blob in streams.items():
        for max_length in (-1, 50_000):
            cuts = sorted(int(c) for c in rng.integers(1, len(blob), 6))
            got = bounded(feed, tpubz_torch.BZ2Decompressor, blob, cuts, max_length)
            assert got == feed(TpubzDecompressor, blob, cuts, max_length), name
            if name != "corrupt":
                assert b"".join(got[0]) == d and got[1] and got[2] == b"tail"


def test_module_surface_matches_stdlib():
    theirs = {n for n in dir(bz2) if not n.startswith("_")} - {"io", "os"}
    assert theirs <= set(dir(tpubz_torch)) and theirs <= set(tpubz_torch.__all__)
    assert "compress_cpu" in tpubz_torch.__all__


@pytest.fixture
def sample(tmp_path):
    d = b"cli file mode sample\n" * 500 + _payload(5, 20_000)
    p = tmp_path / "sample.txt"
    p.write_bytes(d)
    return p, d


def _bz(p):
    return p.parent / (p.name + ".bz2")


def _run(argv, **kw):
    return bounded(cli.run, argv, device="cpu", **kw)


def test_cli_compress_deletes_input_by_default(sample):
    p, d = sample
    assert _run(["-1", str(p)]) == 0
    assert not p.exists() and _bz(p).read_bytes() == compress_cpu(d, 1)


def test_cli_keep_and_bunzip2(sample, sys_bunzip2):
    p, d = sample
    assert _run(["-k", str(p)]) == 0
    assert p.exists()
    assert _bz(p).read_bytes() == compress_cpu(d, 9)
    assert sys_bunzip2(_bz(p).read_bytes()) == d


def test_cli_refuses_existing_output_without_force(sample, sys_bunzip2, capsys):
    p, d = sample
    _bz(p).write_bytes(b"precious")
    assert _run(["-k", str(p)]) == 1
    assert _bz(p).read_bytes() == b"precious" and p.exists()
    assert "already exists" in capsys.readouterr().err
    assert _run(["-kf", str(p)]) == 0
    assert sys_bunzip2(_bz(p).read_bytes()) == d


def test_cli_stdout_flag_touches_nothing(sample, monkeypatch):
    p, d = sample
    buf = io.BytesIO()
    monkeypatch.setattr(sys, "stdout", type("W", (), {"buffer": buf, "flush": lambda s: None})())
    assert _run(["-c", "-k", "-3", str(p)]) == 0
    assert p.exists() and not _bz(p).exists()
    assert buf.getvalue() == compress_cpu(d, 3)


def test_cli_decompress_and_test_mode(sample):
    p, d = sample
    assert _run(["-k", str(p)]) == 0
    p.unlink()
    assert _run(["-t", str(_bz(p))]) == 0
    assert _run(["-d", str(_bz(p))]) == 0
    assert p.read_bytes() == d and not _bz(p).exists()


def test_cli_host_engine(sample):
    p, d = sample
    assert _run(["-k", "--host-engine", str(p)]) == 0
    assert _bz(p).read_bytes() == compress_cpu(d, 9)
    assert papi.last_stream_stats["engine"] == "cpu"


def test_cli_stdin_to_stdout(monkeypatch, capsysbinary):
    d = _payload(6, 50_000)
    monkeypatch.setattr("sys.stdin", type("S", (), {"buffer": io.BytesIO(d)})())
    assert _run(["-q", "-1"]) == 0
    z = capsysbinary.readouterr().out
    assert z == compress_cpu(d, 1)
    monkeypatch.setattr("sys.stdin", type("S", (), {"buffer": io.BytesIO(z)})())
    assert _run(["-q", "-d"]) == 0
    assert capsysbinary.readouterr().out == d


def test_cli_missing_file_exit_code(tmp_path, capsys):
    assert _run([str(tmp_path / "nope.txt")]) == 1
    assert "can't open" in capsys.readouterr().err


def test_cli_profile_writes_a_trace(sample, tmp_path):
    p, d = sample
    trace_dir = tmp_path / "trace"
    assert _run(["-k", f"--profile={trace_dir}", str(p)]) == 0
    assert _bz(p).read_bytes() == compress_cpu(d, 9)
    assert any(name.endswith(".json") for name in os.listdir(trace_dir))


def test_module_entry_point_asks_for_the_card(sample, tmp_path):
    """python -m tpubz_torch runs on "cuda": without a card it fails and
    leaves no partial output."""
    p, _ = sample
    env = dict(os.environ, PYTHONPATH=ROOT, TPUBZ_TORCH_CACHE=str(tmp_path / "c"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "tpubz_torch", "-k", "-1", str(p)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "is_available" in proc.stderr
    assert p.exists() and not _bz(p).exists()


def test_version_equals_tpubz():
    """The port carries tpubz's version string."""
    import tpubz

    assert tpubz_torch.__version__ == tpubz.__version__ == "0.1.0"


@pytest.mark.parametrize("level,size", [(1, 450_000), (9, 5_000), (9, 0)],
                         ids=["five_blocks", "one_block", "empty"])
def test_last_decode_stats_match_tpubz(level, size):
    """Every decompress sets last_decode_stats as tpubz does: the engine
    ("native": the scalar decoder is reached only by --trace-bits), the blocks, equal to tpubz's
    count, and parallel_candidates, an int from 0 to the stream's magic
    hits (the count depends on the scanner thread's pace). Of a
    concatenation, the last stream's."""
    from tpubz.format.constants import BLOCK_MAGIC, FOOTER_MAGIC
    from tpubz.stream import decode as tdecode

    from tpubz_torch.native import find_magic2_native
    from tpubz_torch.stream import decode as pdecode

    data = np.random.default_rng(size).integers(0, 8, size, dtype=np.uint8).tobytes()
    stream = compress_cpu(data, level)
    assert tdecode.decompress(stream) == data
    want = dict(tdecode.last_decode_stats)
    pdecode.last_decode_stats.clear()
    assert tpubz_torch.decompress(stream) == data
    got = dict(pdecode.last_decode_stats)
    hits, footers = find_magic2_native(np.frombuffer(stream, np.uint8), BLOCK_MAGIC, FOOTER_MAGIC)
    candidates = [h for h in hits if 32 <= h < (footers[0] if footers.size else 1 << 62)]
    assert set(got) == {"engine", "blocks", "parallel_candidates"}
    assert got["engine"] == "native" and got["blocks"] == want["blocks"]
    assert isinstance(got["parallel_candidates"], int)
    assert 0 <= got["parallel_candidates"] <= len(candidates)
    if size > 100_000:
        assert got["blocks"] > 1
    tail = compress_cpu(b"xyz" * 1000, 9)
    assert tpubz_torch.decompress(stream + tail) == data + b"xyz" * 1000
    assert pdecode.last_decode_stats["blocks"] == 1


@pytest.fixture
def trace_log(monkeypatch):
    """The ``tpubz_torch`` logger's messages during a test; its level is
    restored after it, and TPUBZ_TRACE_BITS is unset before it."""
    monkeypatch.delenv("TPUBZ_TRACE_BITS", raising=False)
    logger = logging.getLogger("tpubz_torch")
    level = logger.level
    lines = []
    handler = logging.Handler(logging.DEBUG)
    handler.emit = lambda r: lines.append(r.getMessage())
    logger.addHandler(handler)
    yield lines
    logger.removeHandler(handler)
    logger.setLevel(level)


def test_cli_trace_bits_decode(tmp_path, trace_log, sys_bzip2):
    """--trace-bits decodes through the scalar decoder and logs the bit
    position of every header field and decoded symbol; it leaves no
    TPUBZ_TRACE_BITS behind."""
    data = b"trace me, trace me again, trace me once more\n"
    src = tmp_path / "t.bz2"
    src.write_bytes(sys_bzip2(data, 9))
    assert _run(["-d", "-k", "-f", "--trace-bits", str(src)]) == 0
    assert (tmp_path / "t").read_bytes() == data
    msgs = [m for m in trace_log if "read at bit" in m]
    assert any("block CRC" in m for m in msgs)
    assert any(m.startswith("sym ") for m in msgs)
    assert len(msgs) > 10
    assert "TPUBZ_TRACE_BITS" not in os.environ


def test_cli_trace_bits_concat_and_stdin(tmp_path, trace_log, sys_bzip2, monkeypatch,
                                         capsysbinary):
    """--trace-bits decodes every stream of a concatenation, from a file and
    from stdin, through the traced scalar decoder."""
    a, b = b"first stream\n", b"second stream\n"
    blob = sys_bzip2(a, 9) + sys_bzip2(b, 9)
    src = tmp_path / "m.bz2"
    src.write_bytes(blob)
    assert _run(["-d", "-k", "-f", "--trace-bits", str(src)]) == 0
    assert (tmp_path / "m").read_bytes() == a + b
    assert sum(m.startswith("block CRC read at bit") for m in trace_log) == 2
    del trace_log[:]
    monkeypatch.setattr("sys.stdin", type("S", (), {"buffer": io.BytesIO(blob)})())
    assert _run(["-d", "--trace-bits"]) == 0
    assert capsysbinary.readouterr().out == a + b
    assert sum(m.startswith("sym ") for m in trace_log) > 10
    assert "TPUBZ_TRACE_BITS" not in os.environ


def test_cli_program_names(tmp_path, monkeypatch, capsysbinary):
    """tpunzip* decompresses and tpcat* decompresses to stdout, as bunzip2
    and bzcat."""
    assert cli.parse_args([], prog="tpunzip2").mode == "unzip"
    o = cli.parse_args([], prog="/usr/local/bin/tpcat")
    assert o.mode == "unzip" and o.stdout
    assert cli.parse_args([], prog="bzcat").stdout
    d = _payload(7, 20_000)
    src = tmp_path / "p.bz2"
    src.write_bytes(compress_cpu(d, 1))
    assert _run([str(src)], prog="tpcat") == 0
    assert capsysbinary.readouterr().out == d and src.exists()
    assert _run(["-k", str(src)], prog="tpunzip2") == 0
    assert (tmp_path / "p").read_bytes() == d


def test_decode_surfaces_never_reach_the_scalar_codec(tmp_path, monkeypatch, capsysbinary):
    """decompress, open("rb"), BZ2Decompressor and the command line without
    --trace-bits decode natively: with the scalar codec made to raise they
    still decode, and last_decode_stats names the native engine."""
    from tpubz_torch.hostref import block as hblock
    from tpubz_torch.hostref import stream as hstream
    from tpubz_torch.stream import decode as pdecode

    def refuse(*args, **kwargs):
        raise AssertionError("the scalar codec was reached")

    for mod, name in ((hstream, "compress"), (hstream, "decompress"),
                      (hblock, "decode_block"), (hblock, "encode_block")):
        monkeypatch.setattr(mod, name, refuse)
    d = _payload(8, 30_000)
    z = compress_cpu(d, 1)
    pdecode.last_decode_stats.clear()
    assert tpubz_torch.decompress(z) == d
    assert pdecode.last_decode_stats["engine"] == "native"
    src = tmp_path / "s.bz2"
    src.write_bytes(z)
    with tpubz_torch.open(str(src), "rb") as f:
        assert f.read() == d
    assert tpubz_torch.BZ2Decompressor().decompress(z) == d
    assert _run(["-d", "-k", str(src)]) == 0
    assert (tmp_path / "s").read_bytes() == d
    pdecode.last_decode_stats.clear()
    assert _run(["-c", "-d", str(src)]) == 0
    assert capsysbinary.readouterr().out == d
    assert pdecode.last_decode_stats["engine"] == "native"
    monkeypatch.setattr("sys.stdin", type("S", (), {"buffer": io.BytesIO(z)})())
    assert _run(["-d"]) == 0
    assert capsysbinary.readouterr().out == d

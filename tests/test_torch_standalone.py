"""tpubz_torch stands alone: it imports neither tpubz nor jax, and its own copy
of the native host engine gives tpubz's outputs exactly.

A subprocess runs every public surface of the port on the CPU and then
lists its modules; an AST scan finds no import of tpubz in the package or
in chip_smoke.py; each native entry point of the port is held against
``tpubz.native``'s on seeded inputs and the edge blocks of
``tpubz_torch.corpus`` at a cut size (tolerance 0: the codec is integer).
"""
import ast
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tpubz import native as tnative
from tpubz.format.constants import BLOCK_MAGIC, FOOTER_MAGIC
from tpubz.stream.api import compress_cpu as tpubz_compress_cpu

from tpubz_torch import native as pnative
from tpubz_torch.corpus import edge_blocks, mixed_corpus

from torch_native_guard import load_tpubz_native, tpubz_native  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SURFACES = textwrap.dedent("""
    import io, os, runpy, sys
    import numpy as np
    import tpubz_torch
    from tpubz_torch import cli

    d = bytes(np.random.default_rng(3).integers(0, 8, 150_000, dtype=np.uint8)) + b"ab" * 9000
    z = tpubz_torch.compress(d, 1, device="cpu")
    assert z == tpubz_torch.compress_cpu(d, 1)
    assert tpubz_torch.decompress(z) == d
    from tpubz_torch.dist import multihost
    assert multihost.compress_multihost(d, 1, device="cpu") == z
    assert multihost.decompress_multihost(z) == d
    path = os.path.join(sys.argv[1], "f.bz2")
    with tpubz_torch.open(path, "wb", compresslevel=1, device="cpu") as f:
        f.write(d)
    with tpubz_torch.open(path, "rb") as f:
        assert f.read() == d
    c = tpubz_torch.BZ2Compressor(1, device="cpu")
    blob = c.compress(d[:70_000]) + c.compress(d[70_000:]) + c.flush()
    assert blob == z
    dec = tpubz_torch.BZ2Decompressor()
    assert dec.decompress(blob[:1000]) + dec.decompress(blob[1000:]) == d and dec.eof
    src = os.path.join(sys.argv[1], "plain.txt")
    with open(src, "wb") as f:
        f.write(d)
    assert cli.run(["-k", "-1", src], device="cpu") == 0
    os.replace(src + ".bz2", src + ".run.bz2")
    sys.argv = ["tpubz_torch", "-k", "-1", "--host-engine", src]
    try:
        runpy.run_module("tpubz_torch", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        assert e.code == 0, e.code
    for name in (src + ".bz2", src + ".run.bz2"):
        with open(name, "rb") as f:
            assert f.read() == z
    from tpubz_torch.block.encode import DeviceBlockEncoder
    enc = DeviceBlockEncoder(1, device="cpu")
    out = enc.transform(np.frombuffer(d[:100_000], np.uint8))
    assert enc.encode_block_devrefine(out, 7).pack() == enc.emit_block(*enc.fetch(out), 7).pack()
    from tpubz_torch.hostref import stream as scalar
    small = os.path.join(os.path.dirname(src), "small.bz2")
    with open(small, "wb") as f:
        f.write(scalar.compress(d[:20_000], 1))
    assert cli.run(["-d", "-f", "--trace-bits", small], device="cpu") == 0
    with open(small[:-4], "rb") as f:
        assert f.read() == d[:20_000]
    print(" ".join(sorted(m for m in sys.modules
                          if m == "jax" or m.startswith("jax.")
                          or m == "tpubz" or m.startswith("tpubz."))))
""")


def test_public_surfaces_load_no_tpubz_and_no_jax(tmp_path):
    """compress(device="cpu"), compress_cpu, decompress, the multi-process
    path's compress_multihost and decompress_multihost (one process),
    open("wb"/"rb"), BZ2Compressor/BZ2Decompressor, cli.run,
    ``python -m tpubz_torch -k``, the device refine block encoder
    (``encode_block_devrefine``), the scalar codec and ``--trace-bits`` run
    in a fresh interpreter, which then
    holds no tpubz* and no jax* module."""
    env = dict(os.environ, PYTHONPATH=ROOT, TPUBZ_TORCH_CACHE=str(tmp_path / "cache"))
    proc = subprocess.run([sys.executable, "-c", _SURFACES, str(tmp_path)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == ""


def _port_files():
    pkg = os.path.join(ROOT, "tpubz_torch")
    for dirpath, _, names in os.walk(pkg):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_file_of_the_port_imports_tpubz():
    """No import statement of tpubz_torch/ or chip_smoke.py, at any depth,
    names tpubz or a tpubz module (tpubz_torch is another name)."""
    found = []
    files = list(_port_files())
    assert len(files) > 20
    scanned = {os.path.relpath(f, ROOT) for f in files}
    assert {f"tpubz_torch/hostref/{m}.py" for m in ("bwt", "mtf_rle2", "block", "stream",
                                                     "huffman", "rle1", "bitio")} <= scanned
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(path, n) for n in names
                      if n == "tpubz" or n.startswith("tpubz.") or n == "jax" or n.startswith("jax.")]
    assert found == []


@functools.lru_cache(maxsize=1)
def _inputs():
    """Seeded blocks and the edge blocks, cut to a few hundred KB in all
    (made once per process)."""
    rng = np.random.default_rng(2026)
    edges = edge_blocks()
    return {
        "mixed": np.frombuffer(mixed_corpus(1, 5)[:200_000], np.uint8),
        "random": rng.integers(0, 256, 30_000, dtype=np.uint8),
        "few_symbols": rng.integers(0, 3, 40_000, dtype=np.uint8),
        "near_periodic": np.frombuffer(edges["near_periodic"][:60_000] + b"c", np.uint8),
        "one_byte_run": np.frombuffer(edges["one_byte_run"][:50_000], np.uint8),
        "all256": np.frombuffer(edges["all256"][:256 * 300], np.uint8),
        "tiny": np.frombuffer(b"x", np.uint8),
    }


_CASES = ["mixed", "random", "few_symbols", "near_periodic", "one_byte_run", "all256", "tiny"]


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, list):
        assert a == b
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def _rle1(mod, arr):
    return mod.rle1_split_native(arr, 30_000 - 19)


def _mtf_rle2(mod, arr):
    return mod.mtf_rle2_native(arr)


def _transform(mod, arr):
    return mod.block_transform_native(arr)


def _emit(mod, arr):
    key, syms, _, used = tnative.block_transform_native(arr)
    return mod.emit_block_native(key, 0x1234ABCD, syms, used, 8)


def _crc(mod, arr):
    return mod.block_crc_native(arr)


@functools.lru_cache(maxsize=None)
def _stream_of(case):
    return np.frombuffer(tpubz_compress_cpu(_inputs()[case].tobytes(), 1), np.uint8)


def _stream(arr):
    case = next(name for name, a in _inputs().items() if a is arr)
    return _stream_of(case)


def _magic(mod, arr):
    s = _stream(arr)
    return mod.find_magic_native(s, BLOCK_MAGIC), mod.find_magic2_native(s, BLOCK_MAGIC, FOOTER_MAGIC)


def _decode(mod, arr):
    s = _stream(arr)
    out, pos = [], 32
    for hit in tnative.find_magic_native(s, BLOCK_MAGIC):
        if hit == pos:
            raw, pos, stored, actual = mod.decode_block_native(s, int(hit) + 48, 1)
            out.append((raw, pos, stored, actual))
    assert out and np.array_equal(np.concatenate([o[0] for o in out]), arr)
    return tuple(out)


def _code_lengths(mod, arr):
    freqs = np.bincount(arr, minlength=258).astype(np.int64)
    return tuple(mod.code_lengths_native(freqs, alpha) for alpha in (2, 7, 258))


def _mtf_selectors(mod, arr):
    return mod.mtf_selectors_native((arr % 6).astype(np.int32))


_ENTRY_POINTS = {
    "rle1_split": _rle1, "mtf_rle2": _mtf_rle2, "block_transform": _transform,
    "emit_block": _emit, "block_crc": _crc, "magic_scan": _magic, "decode_block": _decode,
    "code_lengths": _code_lengths, "mtf_selectors": _mtf_selectors,
}


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("entry", list(_ENTRY_POINTS))
def test_native_entry_point_matches_tpubz(entry, case, tpubz_native):
    """The port's native entry point gives tpubz.native's output on the same
    input, exactly: RLE1 split, MTF/RLE2, block transform, emission, CRC,
    magic scan, block decode, a table's code lengths and the selector MTF."""
    arr = _inputs()[case]
    fn = _ENTRY_POINTS[entry]
    _equal(fn(pnative, arr), fn(tnative, arr))


def test_window_scan_and_large_magic_scan_match_tpubz(tpubz_native):
    """The RLE1 window scan at an offset, and the chunked two-magic scan of
    an input above its 2.5 MB chunk threshold, equal tpubz's."""
    rng = np.random.default_rng(7)
    arr = np.concatenate([rng.integers(0, 4, 300_000), np.full(2000, 9)]).astype(np.uint8)
    for mod in (pnative, tnative):
        out = np.zeros(arr.size * 2, np.uint8)
        got = mod.rle1_split_window(arr, 1000, arr.size, 50_000 - 19, out, 17)
        if mod is pnative:
            mine = (got, out.copy())
        else:
            _equal(mine, (got, out))
    big = rng.integers(0, 256, 3 << 20, dtype=np.uint8)
    big[12345:12351] = np.frombuffer(BLOCK_MAGIC.to_bytes(6, "big"), np.uint8)
    _equal(pnative.find_magic2_native(big, BLOCK_MAGIC, FOOTER_MAGIC),
           tnative.find_magic2_native(big, BLOCK_MAGIC, FOOTER_MAGIC))


def test_loader_builds_into_the_port_build_dir_and_raises_without_gxx(tmp_path, monkeypatch,
                                                                    tpubz_native):
    """The library lives under tpubz_torch/_build/ and is the port's own
    handle; with no g++ a fresh build raises instead of returning None."""
    lib = pnative.get_lib()
    assert lib is not tnative.get_lib()
    assert pnative.LIB_PATH == os.path.join(ROOT, "tpubz_torch", "_build",
                                            "libtpubz_torch_native.so")
    assert lib._name == pnative.LIB_PATH
    monkeypatch.setattr(pnative, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(pnative, "LIB_PATH", str(tmp_path / "b" / "lib.so"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        pnative.build()
    assert not os.path.exists(pnative.LIB_PATH)


def test_native_guard_recovers_from_a_failed_first_load(tmp_path, monkeypatch):
    """A worker whose first load of tpubz's library failed (a half-written
    file: _LIB_FAILED set for good) loads it under the guard's lock; a load
    that keeps failing fails the test with a clear message."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_LIB_FAILED", True)
    assert tnative.get_lib() is None
    assert load_tpubz_native(tmp_path / "lock", monkeypatch) is tnative
    assert tnative.get_lib() is not None and not tnative._LIB_FAILED
    key, syms, _, _ = tnative.block_transform_native(_inputs()["random"])
    assert syms.size > 0
    monkeypatch.setattr(tnative, "_build", lambda: None)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_LIB_FAILED", True)
    with pytest.raises(pytest.fail.Exception, match="did not load"):
        load_tpubz_native(tmp_path / "lock", monkeypatch, wait_s=0.3, poll_s=0.05)

"""The port's nvcc build loader (tpubz_torch.kernels._build), with a stand-in
nvcc script so the tests run without the CUDA toolkit."""
import os
import stat
import sys

import pytest

from tpubz_torch.kernels import _build


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\nimport sys\n{body}\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", str(out))
    monkeypatch.setattr(_build, "LIB_PATH", str(out / "lib.so"))
    return out


def test_build_compiles_every_source_for_sm90a_then_reuses(tmp_path, build_dir, monkeypatch):
    """The first build compiles every csrc/*.cu with the sm_90a flags, one
    nvcc each, links them into the library, and a library newer than its
    sources is reused."""
    log = tmp_path / "calls.txt"
    nvcc = _fake_nvcc(
        tmp_path,
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'lib')",
    )
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    assert _build.build() == _build.LIB_PATH
    assert os.path.exists(_build.LIB_PATH)
    *compiles, link = log.read_text().splitlines()
    srcs = _build.sources()
    assert any(s.endswith("mtf_dominance.cu") for s in srcs)
    assert any(s.endswith("bitonic.cu") for s in srcs)
    assert sorted(c.split()[c.split().index("-c") + 1] for c in compiles) == srcs
    assert all("arch=compute_90a,code=sm_90a" in c and "-shared" not in c for c in compiles)
    assert "-shared" in link and "-c" not in link.split()
    assert len([a for a in link.split() if a.endswith(".o")]) == len(srcs)
    assert _build.build() == _build.LIB_PATH
    assert len(log.read_text().splitlines()) == len(srcs) + 1  # up to date: no rebuild
    assert sorted(os.listdir(build_dir)) == ["lib.so"]  # no temporary left


def test_touching_a_header_rebuilds(tmp_path, build_dir, monkeypatch):
    """A header in csrc/ is an input of the library but not of nvcc's
    command line: a header newer than the library rebuilds it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kernel.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// shared\n")
    (csrc / "notes.txt").write_text("not an input\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    log = tmp_path / "calls.txt"
    nvcc = _fake_nvcc(
        tmp_path,
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'lib')",
    )
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    assert _build.sources() == [str(csrc / "kernel.cu")]
    assert _build.inputs() == [str(csrc / "common.cuh"), str(csrc / "kernel.cu")]
    _build.build()
    _build.build()
    assert len(log.read_text().splitlines()) == 2  # compile and link, once
    lib_mtime = os.path.getmtime(_build.LIB_PATH)
    os.utime(csrc / "notes.txt", (lib_mtime + 10, lib_mtime + 10))
    _build.build()
    assert len(log.read_text().splitlines()) == 2  # not an input: no rebuild
    os.utime(csrc / "common.cuh", (lib_mtime + 10, lib_mtime + 10))
    _build.build()
    calls = log.read_text().splitlines()
    assert len(calls) == 4
    assert all("common.cuh" not in c for c in calls)  # nvcc compiles only the .cu files


def test_failed_build_raises_with_nvcc_stderr(tmp_path, build_dir, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, "sys.stderr.write('error: bad kernel\\n')\nsys.exit(2)")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build()
    assert not os.path.exists(_build.LIB_PATH)
    assert os.listdir(build_dir) == []


def test_every_entry_point_passes_pointers_as_void_p():
    """ctypes would cut a pointer passed as a plain int to 32 bits."""
    import ctypes

    argtypes = _build.SIGNATURES["tpubz_mtf_dominance"]
    assert argtypes.count(ctypes.c_void_p) == 6 and argtypes[5] is ctypes.c_int
    ints = ctypes.POINTER(ctypes.c_int)
    for key in ("i32", "i64"):
        assert _build.SIGNATURES[f"tpubz_bitonic_sort_{key}"] == [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ints, ctypes.c_void_p]
        assert _build.SIGNATURES[f"tpubz_bitonic_stage_{key}"] == [
            ctypes.c_void_p, ctypes.c_int, ints, ctypes.c_int, ints, ctypes.c_void_p]


def test_every_entry_point_is_defined_in_csrc():
    """Each name in SIGNATURES is an extern "C" function of a csrc/*.cu
    file, and the bitonic kernels are among the sources."""
    text = "".join(open(s).read() for s in _build.sources())
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text
    assert any(s.endswith("bitonic.cu") for s in _build.sources())

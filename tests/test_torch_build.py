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
    for name in ("mtf.cu", "rle2.cu", "bitonic.cu", "bwt.cu", "radix.cu"):
        assert any(s.endswith(name) for s in srcs)
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

    P, I = ctypes.c_void_p, ctypes.c_int
    assert _build.SIGNATURES["tpubz_mtf_ranks"] == [P, I, I, I, P, P, P, P]
    assert _build.SIGNATURES["tpubz_rle2"] == [P, I, I, P, P, I, P, P, P, P]
    ints = ctypes.POINTER(ctypes.c_int)
    assert _build.SIGNATURES["tpubz_bwt_forward"] == [P, I, I, P, I, P, P, P, ints, P]
    assert _build.SIGNATURES["tpubz_bwt_sizes"] == [I, ints]
    assert _build.SIGNATURES["tpubz_radix_sort"] == [P, P, I, I, I, P, I, ints, P]
    assert _build.SIGNATURES["tpubz_radix_sizes"] == [I, ints]
    for key in ("i32", "i64"):
        assert _build.SIGNATURES[f"tpubz_bitonic_run_{key}"] == [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ints, ctypes.c_int, ints,
            ctypes.c_void_p]


def test_every_entry_point_is_defined_in_csrc():
    """Each name in SIGNATURES is an extern "C" function of a csrc/*.cu
    file, and the bitonic and radix kernels are among the sources."""
    text = "".join(open(s).read() for s in _build.sources())
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text
    assert any(s.endswith("bitonic.cu") for s in _build.sources())
    assert any(s.endswith("radix.cu") for s in _build.sources())


def test_batch_entry_points_pass_pointers_as_void_p():
    """The multi-process path's entry points: device pointers and the stream
    as c_void_p, host int arrays as int pointers, the batched BWT's scratch
    size as a long long (B rows of ~30 MB pass 2^31 bytes)."""
    import ctypes

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ints = ctypes.POINTER(ctypes.c_int)
    assert _build.SIGNATURES["tpubz_bwt_forward_batch"] == [P, ints, I, I, P, L, P, P, P, ints, P]
    assert _build.SIGNATURES["tpubz_bwt_batch_sizes"] == [ints, I, ctypes.POINTER(L)]
    assert _build.SIGNATURES["tpubz_mtf_ranks_batch"] == [P, P, I, I, I, P, P, P, P]
    assert _build.SIGNATURES["tpubz_rle2_batch"] == [P, P, I, I, P, P, I, P, P, P, P]
    assert _build.SIGNATURES["tpubz_stage_compact"] == [P, P, I, I, P, P, P, P, P]


def test_builds_at_once_run_nvcc_once(tmp_path, build_dir, monkeypatch):
    """Builds started together (the ranks of a multi-process run on a fresh
    checkout) take turns on the build directory's lock: one runs nvcc, the
    others find its library fresh, and no lock file is left."""
    import threading

    log = tmp_path / "calls.txt"
    nvcc = _fake_nvcc(
        tmp_path,
        "import time\ntime.sleep(0.3)\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'lib')",
    )
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    results = []
    threads = [threading.Thread(target=lambda: results.append(_build.build())) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert results == [_build.LIB_PATH] * 3
    assert len(log.read_text().splitlines()) == len(_build.sources()) + 1
    assert sorted(os.listdir(build_dir)) == ["lib.so"]

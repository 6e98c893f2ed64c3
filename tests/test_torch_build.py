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
    """The first build passes every csrc/*.cu with the sm_90a flags and
    writes the library; a library newer than its sources is reused."""
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
    (call,) = log.read_text().splitlines()
    assert "arch=compute_90a,code=sm_90a" in call and "-shared" in call
    srcs = _build.sources()
    assert srcs and all(s in call.split() for s in srcs)
    assert any(s.endswith("mtf_dominance.cu") for s in srcs)
    assert _build.build() == _build.LIB_PATH
    assert len(log.read_text().splitlines()) == 1  # up to date: no rebuild
    assert sorted(os.listdir(build_dir)) == ["lib.so"]  # no temporary left


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

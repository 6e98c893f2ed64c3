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
    ints = ctypes.POINTER(ctypes.c_int)
    assert _build.SIGNATURES["tpubz_rle2"] == [P, I, I, I, P, P, P, P, P, P, P, P,
                                               ctypes.c_longlong, ints, P]
    assert _build.SIGNATURES["tpubz_rle2_compact"] == [P, I, I, P, P, P, P, P, P, P, P,
                                                       ctypes.c_longlong, ints, P]
    assert "tpubz_bwt_forward" not in _build.SIGNATURES  # the batch of one row
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
    size as a long long (B rows of ~30 MB pass 2^31 bytes); the BWT's
    least n that takes rounds and round cap as ints."""
    import ctypes

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ints = ctypes.POINTER(ctypes.c_int)
    assert _build.SIGNATURES["tpubz_bwt_forward_batch"] == [P, ints, I, I, I, I, P, L, P, P, P, ints,
                                                            P]
    assert _build.SIGNATURES["tpubz_bwt_batch_sizes"] == [ints, I, ctypes.POINTER(L)]
    assert _build.SIGNATURES["tpubz_mtf_ranks_batch"] == [P, P, I, I, I, P, P, P, P]
    assert _build.SIGNATURES["tpubz_rle2_batch"] == [P, P, I, I, P, P, P, P, P, P, L, ints, P]
    assert _build.SIGNATURES["tpubz_stage_compact"] == [P, P, I, I, P, L, ctypes.c_uint, L, P, P,
                                                        P, P]


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


def test_rle2_probe_variants_follow_the_source():
    """Each variant of tpubz_torch.rle2_probe applies its edits to
    csrc/rle2.cu as it is, and changes it."""
    from tpubz_torch import rle2_probe

    texts = rle2_probe.variant_sources()
    assert set(texts) == set(rle2_probe.VARIANTS)
    base = texts.pop("as_is")
    assert all(t != base for t in texts.values())


def test_rle2_wrapper_constants_follow_the_source():
    """kernels/rle2.py's tile and output limit, from which it sizes the
    scratch and refuses rows, are csrc/rle2.cu's."""
    import re

    from tpubz_torch.kernels import rle2

    text = open(os.path.join(_build.CSRC_DIR, "rle2.cu")).read()
    value = {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
             for name in ("kThreads", "kPer", "kFieldBits")}
    assert rle2.TILE == value["kThreads"] * value["kPer"]
    assert rle2.MAX_OUT == 1 << value["kFieldBits"]
    assert rle2.scratch_bytes(1, 0) == 8 + 4 and rle2.scratch_bytes(2, 4097) == 2 * (16 + 4)


def test_ibwt_densities_follow_the_source():
    """kernels/ibwt.py's splitter windows and kept bytes are csrc/ibwt.cu's, and
    every density ibwt_probe builds fits the top's nodes (level-2 nodes of
    8 bytes, levels 3 and 4 of 12 at n = 2^20) in one CTA's shared memory,
    a level-4 node a thread, as the source's static_asserts demand."""
    import re

    from tpubz_torch import ibwt_probe
    from tpubz_torch.kernels import ibwt

    text = open(os.path.join(_build.CSRC_DIR, "ibwt.cu")).read()
    assert tuple(int(re.search(rf"constexpr int kLog{k} = (\d+);", text).group(1))
                 for k in (1, 2, 3)) == ibwt.LOG_D == ibwt_probe.DENSITIES["as_is"]
    assert int(re.search(r"constexpr int kBuffered = (\d+);", text).group(1)) == ibwt.KEPT
    assert len(ibwt_probe.DENSITIES) >= 3
    for l1, l2, l3 in ibwt_probe.DENSITIES.values():
        level2 = ((((1 << 20) >> l1) + 1 + (1 << l2) - 1) >> l2) + 1
        level3 = ((level2 + (1 << l3) - 1) >> l3) + 1
        level4 = ((level3 + (1 << l3) - 1) >> l3) + 1
        assert 8 * level2 + 12 * level3 + 12 * level4 <= 227 * 1024 and level4 <= 1024
        assert min(l1, l2, l3) >= 1


@pytest.mark.parametrize("level", [1, 2])
def test_with_tied_tail_ends_in_whole_periods(level):
    """corpus.with_tied_tail: the last block lies in the tail and is a whole
    number of its 256-byte periods (rotations tied), as chip_smoke.py and
    ibwt_probe take it."""
    import numpy as np

    from tpubz_torch.corpus import with_tied_tail
    from tpubz_torch.format.constants import block_budget
    from tpubz_torch.hostref.rle1 import rle1_blocks

    head = bytes(np.random.default_rng(level).integers(0, 256, 150_000, dtype=np.uint8))
    data = with_tied_tail(head, level)
    _, cuts = rle1_blocks(np.frombuffer(data, np.uint8), block_budget(level))
    o0, o1, i0, i1 = cuts[-1]
    assert i0 >= len(head) and (o1 - o0) % 256 == 0 and i1 == len(data)
    last = data[i0:]  # the tail's bytes in order, from some phase
    assert last == last[:256] * ((o1 - o0) // 256) and sorted(last[:256]) == list(range(256))


def test_ibwt_probe_timeline_follows_the_source():
    """The probe's timeline edits each apply once to csrc/ibwt.cu and
    csrc/huffman_dev.cu as they are, and so do its variants' (densities,
    CTA shapes, the refinement's alternatives)."""
    from tpubz_torch import ibwt_probe

    for text, edits in ((ibwt_probe.timeline_source(), ibwt_probe.TIMELINE),
                        (ibwt_probe.refine_timeline_source(), ibwt_probe.REFINE_TIMELINE)):
        assert text.count("g_marks[") == sum(new.count("g_marks[") for _, new in edits)
    other = ibwt_probe._edited(ibwt_probe.REFINE_SOURCE, ibwt_probe.RUNS_IN_REGISTERS)
    assert "run_a += s == 0" in other
    other = ibwt_probe._edited(ibwt_probe.REFINE_SOURCE, ibwt_probe.LENS_16BIT)
    assert "uint4 s_len[" in other
    for logs in ibwt_probe.DENSITIES.values():
        other = ibwt_probe._edited(ibwt_probe.SOURCE, ibwt_probe.density_edits(logs))
        assert f"constexpr int kLog1 = {logs[0]};" in other
    for shape in ibwt_probe.REFINE_SHAPES.values():
        other = ibwt_probe._edited(ibwt_probe.REFINE_SOURCE, ibwt_probe.shape_edits(shape))
        assert f"constexpr int kRefineWarps = {shape[0]};" in other

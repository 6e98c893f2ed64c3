"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by nvcc for Hopper (``sm_90a``), one
nvcc process per source and all at once, and linked into one shared library
with a plain C interface, ``tpubz_torch/_build/libtpubz_torch_kernels.so``.
No PyTorch header is included, so the build takes seconds. The library is
rebuilt when a source or a header in ``csrc/`` is newer than it (the rule
of ``tpubz/native/__init__.py:_build``, with headers watched too).
The sources in the checkout are the build's only inputs. Processes that
build at once (the ranks of a multi-process run on a fresh checkout) take
turns on a lock (flock on the build directory; the host engine's build
takes one on a lock file), so that one of them runs nvcc and the others
load its library.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libtpubz_torch_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
# C entry points of the library: every pointer and the stream as c_void_p
# (a bare Python int would be passed as a 32-bit int and cut the pointer).
# Each returns cudaGetLastError() after its launches.
_INTS = ctypes.POINTER(ctypes.c_int)  # host int array, or an int out argument
SIGNATURES = {
    # last, n, N, group, scratch, used, ranks, stream
    "tpubz_mtf_ranks": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
    # ranks, n, N, eob, scratch, nb, syms, rle2_len, freqs, stream
    "tpubz_rle2": [_P, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P, _P, _P],
    # keys, payload or None, n, plan, len(plan), launched (out), stream
    "tpubz_bitonic_run_i32": [_P, _P, ctypes.c_int, _INTS, ctypes.c_int, _INTS, _P],
    "tpubz_bitonic_run_i64": [_P, _P, ctypes.c_int, _INTS, ctypes.c_int, _INTS, _P],
    # data, n, N, scratch, its bytes, pinned host int32 words, key, last,
    # stats (out, 7 ints), stream
    "tpubz_bwt_forward": [_P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P, _P, _P, _INTS,
                          _P],
    # n, sizes (out, 4 ints: scratch bytes, pinned words, round cap, radix
    # passes a round)
    "tpubz_bwt_sizes": [ctypes.c_int, _INTS],
    # data, ns (host ints), B, N, scratch, its bytes, pinned host int32
    # words, keys, lasts, stats (out, 8 ints), stream
    "tpubz_bwt_forward_batch": [_P, _INTS, ctypes.c_int, ctypes.c_int, _P, ctypes.c_longlong, _P,
                                _P, _P, _INTS, _P],
    # ns (host ints), B, sizes (out, 3 long longs: scratch bytes, pinned
    # words, the most rows a call takes)
    "tpubz_bwt_batch_sizes": [_INTS, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)],
    # lasts, n (device int32[B]), B, N, group, scratch, used, ranks, stream
    "tpubz_mtf_ranks_batch": [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
    # ranks, n (device int32[B]), B, N, eob (device int32[B]), scratch, nb,
    # syms, rle2_len, freqs, stream
    "tpubz_rle2_batch": [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P, _P,
                         _P],
    # syms, rle2_len, B, OUT, scratch, syms_u8, hi_packed, hi_count, stream
    "tpubz_stage_compact": [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P],
    # keys, out, n, lo bit, hi bit, scratch, its bytes, launched (out), stream
    "tpubz_radix_sort": [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
                         _INTS, _P],
    # n, sizes (out, 2 ints: scratch bytes, digit bits)
    "tpubz_radix_sizes": [ctypes.c_int, _INTS],
    # syms, their bytes, rle2_len, its bytes, B, OUT, hist, stream
    "tpubz_chunk_hist": [_P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P],
    # hist, lens, table count, nsel, sel, rfreq, stream
    "tpubz_refine_pass": [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P],
    # vals, bits, m, out words, scratch, words, total, stream
    "tpubz_pack_bits_device": [_P, _P, ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P],
    # syms, their bytes, rle2_len, its bytes, sel, codes, lens, m, out words,
    # scratch, words, total, stream
    "tpubz_pack_payload": [_P, ctypes.c_int, _P, ctypes.c_int, _P, _P, _P, ctypes.c_int,
                           ctypes.c_longlong, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _csrc(suffixes) -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(suffixes)
    )


def sources() -> list[str]:
    """The files nvcc compiles: every csrc/*.cu."""
    return _csrc(".cu")


def inputs() -> list[str]:
    """The files the library depends on: the sources and the headers they
    include (csrc/*.cuh, csrc/*.h)."""
    return _csrc((".cu", ".cuh", ".h"))


def _run_all(cmds) -> None:
    """Run the commands side by side; raise RuntimeError with the stderr of
    the first that failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    errs = [p.communicate()[1] for p in procs]
    for cmd, proc, err in zip(cmds, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n{err}"
            )


def build() -> str:
    """Compile the sources unless the library is newer than every input:
    one nvcc per source, all at once, then one link. Processes that build
    at once take turns on the build directory's lock. Raises RuntimeError
    with nvcc's stderr when the build fails."""
    srcs = sources()
    stamp = max(os.path.getmtime(s) for s in inputs())

    def fresh() -> bool:
        return os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= stamp

    if fresh():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # the lock is the build directory itself, so that it leaves no file
    lock = os.open(BUILD_DIR, os.O_RDONLY)
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():  # another process built it while this one waited
            return LIB_PATH
        nvcc = _nvcc()
        # build beside the target and rename, so a loader that takes no
        # lock never opens a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            objs = [os.path.join(work, os.path.basename(s) + ".o") for s in srcs]
            _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o] for s, o in zip(srcs, objs)])
            lib = os.path.join(work, "lib.so")
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
            os.replace(lib, LIB_PATH)
    finally:
        os.close(lock)  # and with it the lock
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library, built on the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib

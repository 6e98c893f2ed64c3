"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by nvcc for Hopper (``sm_90a``), one
nvcc process per source and all at once, and linked into one shared library
with a plain C interface, ``tpubz_torch/_build/libtpubz_torch_kernels.so``.
No PyTorch header is included, so the build takes seconds. The library is
rebuilt when a source or a header in ``csrc/`` is newer than it (the rule
of ``tpubz/native/__init__.py:_build``, with headers watched too).
The sources in the checkout are the build's only inputs.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""
from __future__ import annotations

import ctypes
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
# Each returns cudaGetLastError() after its launch.
_INTS = ctypes.POINTER(ctypes.c_int)  # host int array, or an int out argument
SIGNATURES = {
    "tpubz_mtf_dominance": [_P, _P, _P, _P, _P, ctypes.c_int, _P],
    # keys, payload or None, n, launched (out), stream
    "tpubz_bitonic_sort_i32": [_P, _P, ctypes.c_int, _INTS, _P],
    "tpubz_bitonic_sort_i64": [_P, _P, ctypes.c_int, _INTS, _P],
    # keys, n, js, len(js), launched (out), stream
    "tpubz_bitonic_stage_i32": [_P, ctypes.c_int, _INTS, ctypes.c_int, _INTS, _P],
    "tpubz_bitonic_stage_i64": [_P, ctypes.c_int, _INTS, ctypes.c_int, _INTS, _P],
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
    one nvcc per source, all at once, then one link. Raises RuntimeError
    with nvcc's stderr when the build fails."""
    srcs = sources()
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= max(
        os.path.getmtime(s) for s in inputs()
    ):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    # build beside the target and rename, so a concurrent loader never
    # opens a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, os.path.basename(s) + ".o") for s in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o] for s, o in zip(srcs, objs)])
        lib = os.path.join(work, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, LIB_PATH)
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

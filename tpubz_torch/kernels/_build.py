"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by nvcc for Hopper (``sm_90a``) into
one shared library with a plain C interface,
``tpubz_torch/_build/libtpubz_torch_kernels.so``. No PyTorch header is
included, so the build takes seconds. The library is rebuilt when a source
is newer than it (the same rule as ``tpubz/native/__init__.py:_build``).
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
# C entry points of the library: every pointer and the stream as c_void_p
# (a bare Python int would be passed as a 32-bit int and cut the pointer).
# Each returns cudaGetLastError() after its launch.
SIGNATURES = {
    "tpubz_mtf_dominance": [_P, _P, _P, _P, _P, ctypes.c_int, _P],
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


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


def build() -> str:
    """Compile the sources unless the library is newer than all of them.
    Raises RuntimeError with nvcc's stderr when the build fails."""
    srcs = sources()
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= max(
        os.path.getmtime(s) for s in srcs
    ):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build beside the target and rename, so a concurrent loader never
    # opens a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
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

"""The inverse BWT on a torch device: next pointers and pointer doubling.

The counterpart of ``tpubz/kernels/ibwt.py``. ``next_pointers`` is
``_next_pointers``: the stable (byte, position) order of the last column,
the lanes at or past n counting as byte 256, so that ``nxt[n:]`` is
``arange(n, N)``. ``bwt_inverse_device`` is tpubz's: the orbit of the key
under ``nxt`` in ceil(log2 n) doubling steps (``positions[k:2k] =
jump^k(positions[:k])``, then ``jump = jump[jump]``), and the block is
``last[positions]``. As in tpubz, no decode route takes it: the decoder is
the native engine's chase (``native/decode.cpp``).

For a CUDA tensor each is one call into ``csrc/ibwt.cu``: the next pointers
by a counting sort (the keys and their byte histogram in one launch, one
onesweep 8-bit pass of ``csrc/radix.cuh``, the pointers read off the sorted
keys), and the inverse with every doubling round enqueued back to back
after them (tpubz drives each round from the host). For a CPU tensor they
run the plain versions ``next_pointers_ref`` (a counting sort in torch: a
byte's positions in order, byte by byte) and ``bwt_inverse_device_ref``
(tpubz's doubling loop in torch).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

MAX_N = 1 << 20  # a position fits the sort key's 20 bits (csrc/ibwt.cu)

# calls whose kernels ran on the card in this process (CPU calls are not
# counted): the next pointers (next_pointers' calls and those inside each
# bwt_inverse_device call, counted where the library reports all
# NEXT_KERNELS launches, so not for n = 0), bwt_inverse_device's calls of
# n > 0 (the inverse's kernels), and the doubling rounds those ran
NEXT_KERNELS = 3  # csrc/ibwt.cu: the keys and histogram, one 8-bit pass, the pointers
NEXT_LAUNCHES = 0
INVERSE_LAUNCHES = 0
ROUNDS_RUN = 0
_launch_lock = threading.Lock()


def next_pointers_ref(last: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of ``next_pointers``."""
    N = last.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=last.device)
    sym = torch.where(idx < n, last.to(torch.int32), 256)
    nxt = torch.empty(N, dtype=torch.int32, device=last.device)
    at = 0
    for b in range(257):
        pos = torch.nonzero(sym == b).flatten()  # ascending
        nxt[at: at + pos.numel()] = pos.to(torch.int32)
        at += pos.numel()
    return nxt


def bwt_inverse_device_ref(key: int, last: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of ``bwt_inverse_device``: tpubz's loop."""
    nxt = next_pointers_ref(last, n)
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=last.device)
    positions = torch.empty(n, dtype=torch.int64, device=last.device)
    positions[0] = nxt[key]
    filled = 1
    jump = nxt.to(torch.int64)
    while filled < n:
        take = min(filled, n - filled)
        positions[filled: filled + take] = jump[positions[:take]]
        filled += take
        if filled < n:
            jump = jump[jump]
    return last[positions]


def _check(last: torch.Tensor, n: int) -> None:
    if last.dtype != torch.uint8 or last.dim() != 1:
        raise TypeError("the inverse BWT takes a 1-D uint8 tensor")
    if not 0 <= n <= last.shape[0]:
        raise ValueError(f"n={n} outside [0, {last.shape[0]}]")


def _sizes(lib, n: int, N: int) -> tuple[int, int]:
    if n > MAX_N:
        raise ValueError(f"the CUDA kernels take blocks of at most {MAX_N} bytes, got {n}")
    sizes = (ctypes.c_longlong * 2)()
    if lib.tpubz_ibwt_sizes(n, N, sizes) != 0:
        raise ValueError(f"the CUDA kernels do not take n={n} of N={N}")
    return sizes[0], sizes[1]


def next_pointers(last: torch.Tensor, n: int) -> torch.Tensor:
    """last: uint8[N], the first n the BWT's last column.

    Returns nxt int32[N]: nxt[j] is the position of the j-th entry of last
    in (byte, position) order, positions >= n after every byte. A CUDA
    tensor launches the kernels on the current stream or raises; a CPU
    tensor runs the plain version."""
    global NEXT_LAUNCHES
    _check(last, n)
    dev = last.device
    if dev.type == "cpu":
        return next_pointers_ref(last, n)
    if dev.type != "cuda":
        raise ValueError(f"next_pointers: unsupported device {dev}")
    N = last.shape[0]
    lib = _build.load()
    scratch_bytes, _ = _sizes(lib, n, N)
    last = last.contiguous()
    scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8, device=dev)
    nxt = torch.empty(N, dtype=torch.int32, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_next_pointers(last.data_ptr(), n, N, scratch.data_ptr(), scratch_bytes,
                                     nxt.data_ptr(), ctypes.byref(launched), stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_next_pointers launch failed: CUDA error {rc}")
    with _launch_lock:
        NEXT_LAUNCHES += launched.value >= NEXT_KERNELS
    return nxt


def bwt_inverse_device(key: int, last: torch.Tensor, n: int) -> torch.Tensor:
    """Invert the rotation BWT (key, last[:n]). Returns uint8[n] on last's
    device. A CUDA tensor makes one library call (the next pointers and
    every doubling round, enqueued on the current stream) or raises; a CPU
    tensor runs the plain version."""
    global NEXT_LAUNCHES, INVERSE_LAUNCHES, ROUNDS_RUN
    _check(last, n)
    key = int(key)
    if n and not 0 <= key < n:
        raise ValueError(f"key={key} outside [0, {n})")
    dev = last.device
    if dev.type == "cpu":
        return bwt_inverse_device_ref(key, last, n)
    if dev.type != "cuda":
        raise ValueError(f"bwt_inverse_device: unsupported device {dev}")
    N = last.shape[0]
    lib = _build.load()
    _, scratch_bytes = _sizes(lib, n, N)
    last = last.contiguous()
    scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8, device=dev)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    launched, rounds = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_bwt_inverse(last.data_ptr(), key if n else 0, n, N, scratch.data_ptr(),
                                   scratch_bytes, out.data_ptr(), ctypes.byref(launched),
                                   ctypes.byref(rounds), stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_bwt_inverse launch failed: CUDA error {rc}")
    with _launch_lock:
        NEXT_LAUNCHES += launched.value >= NEXT_KERNELS
        INVERSE_LAUNCHES += n > 0
        ROUNDS_RUN += rounds.value
    return out


def rounds_for(n: int) -> int:
    """The doubling rounds of an inverse of n bytes: ceil(log2 n), 0 below 2."""
    return max(n - 1, 0).bit_length()

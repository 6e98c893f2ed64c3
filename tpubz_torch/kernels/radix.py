"""LSD radix sort of int64 keys by a range of their bits, keys only.

The sort under the BWT's doubling rounds (``suffix_sort.bwt_forward``),
which took the place there of the bitonic sorts of ``csrc/bitonic.cu``
(the counterparts of ``tools/probe_pallas_sort.py:110 bitonic_1op`` and
``:121 bitonic_2op``; they stay ported beside it). A key carries its own
payload in the bits below the range (the BWT puts a rotation's position in
bits 0-19 and sorts bits 20-59), so there is no second array.

For a CUDA tensor ``radix_sort`` is one call into the kernel library
(``csrc/radix.cu``, whose kernels live in ``csrc/radix.cuh`` so that
``csrc/bwt.cu`` runs the same passes inside its own call): one launch
histograms every digit of the keys, then one launch a digit moves the keys
to their places, onesweep style (a tile ticket from an atomic counter,
per-warp multisplit ranking in shared memory, decoupled look-back over
per-tile status words, coalesced writes of each digit's run). For a CPU
tensor it runs the plain version ``radix_sort_ref``: the same passes, each a
stable order by one digit.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

# the plain version's digit: the kernels' (csrc/radix.cuh's kDigitBits,
# which the library reports: library_sizes), so that both run the same
# passes; any width gives the same order
DIGIT_BITS = 8
MAX_LOG2 = 20

# calls of radix_sort into the kernel library in this process (CPU calls
# are not counted)
LAUNCHES = 0
# sorts run on the card: those calls and the BWT call's rounds (one sort
# a doubling round run), and the kernel launches of the passes they made
# (the histogram launch of a standalone sort included)
SORTS = 0
PASS_LAUNCHES = 0
_launch_lock = threading.Lock()


def passes(lo_bit: int, hi_bit: int, digit_bits: int) -> list[tuple[int, int]]:
    """The (shift, width) of each pass, least significant digit first."""
    return [(s, min(digit_bits, hi_bit - s)) for s in range(lo_bit, hi_bit, digit_bits)]


def _check_range(lo_bit: int, hi_bit: int, digit_bits: int) -> None:
    if digit_bits < 1:
        raise ValueError(f"digit_bits must be positive, got {digit_bits}")
    if not 0 <= lo_bit < hi_bit <= 63:
        raise ValueError(f"the bit range must satisfy 0 <= lo < hi <= 63, got [{lo_bit}, {hi_bit})")


def radix_sort_ref(keys: torch.Tensor, lo_bit: int, hi_bit: int, digit_bits: int) -> torch.Tensor:
    """Plain torch version of ``radix_sort``: one stable pass a digit, any
    digit width."""
    _check_range(lo_bit, hi_bit, digit_bits)
    out = keys
    for shift, width in passes(lo_bit, hi_bit, digit_bits):
        digit = (out >> shift) & ((1 << width) - 1)
        out = out[torch.argsort(digit, stable=True)]
    return out


def count_sorts(sorts: int, pass_launches: int) -> None:
    """Count sorts that another entry point of the library ran through the
    passes of csrc/radix.cuh (the BWT's rounds): SORTS and PASS_LAUNCHES,
    not LAUNCHES, which counts this module's own calls."""
    global SORTS, PASS_LAUNCHES
    with _launch_lock:
        SORTS += sorts
        PASS_LAUNCHES += pass_launches


def library_sizes(n: int) -> tuple[int, int]:
    """(scratch bytes, digit bits) of a library sort of n keys: csrc/radix.cu
    alone knows its layout and its digit."""
    sizes = (ctypes.c_int * 2)()
    _build.load().tpubz_radix_sizes(n, sizes)
    return sizes[0], sizes[1]


def radix_sort(keys: torch.Tensor, lo_bit: int, hi_bit: int) -> torch.Tensor:
    """The int64 keys ordered by their bits [lo_bit, hi_bit) as an unsigned
    number, equal fields in their input order (stable), as a new tensor.
    A CUDA tensor makes one call into the kernel library on the current
    stream or raises; a CPU tensor runs the plain version."""
    global LAUNCHES, SORTS, PASS_LAUNCHES
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError("radix_sort takes a 1-D int64 tensor")
    _check_range(lo_bit, hi_bit, DIGIT_BITS)
    n = keys.shape[0]
    if n > 1 << MAX_LOG2:
        raise ValueError(f"radix_sort takes at most 2^{MAX_LOG2} keys, got {n}")
    dev = keys.device
    if dev.type == "cpu":
        return radix_sort_ref(keys, lo_bit, hi_bit, DIGIT_BITS)
    if dev.type != "cuda":
        raise ValueError(f"radix_sort: unsupported device {dev}")
    if not keys.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous tensor")
    out = torch.empty_like(keys)
    if n == 0:
        return out
    nbytes = library_sizes(n)[0]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.load().tpubz_radix_sort(keys.data_ptr(), out.data_ptr(), n, lo_bit, hi_bit,
                                            scratch.data_ptr(), nbytes, ctypes.byref(launched),
                                            stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_radix_sort launch failed: CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
        SORTS += 1
        PASS_LAUNCHES += launched.value
    return out

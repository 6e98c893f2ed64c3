"""Move-to-front with RLE2 zero-run coding in numpy and Python lists, for
the scalar codec.

The counterpart of ``tpubz/hostref/mtf_rle2.py``, written apart from the
card's kernels and the native engine. The MTF alphabet is the block's byte
values in use, ascending. Rank 0 is never emitted alone: a run of n zeros is
written in bijective base 2, low digit first (RUNA = 0, RUNB = 1); a rank
r >= 1 becomes the symbol r + 1; the EOB, the number of byte values in use
plus 1, ends the block.
"""
from __future__ import annotations

import numpy as np

from ..format.constants import ZERO_BOMB


def zero_run_digits(n: int) -> list[int]:
    """The bijective base-2 digits of a run of n zeros (RUNA 0, RUNB 1)."""
    digits = []
    n -= 1
    while True:
        digits.append(n & 1)
        if n < 2:
            break
        n = (n - 2) >> 1
    return digits


def mtf_rle2_encode(block: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A BWT last column -> (RLE2 symbols uint16 with the EOB last,
    frequencies uint32[258], used bool[256])."""
    block = np.asarray(block, dtype=np.uint8)
    used = np.zeros(256, dtype=bool)
    used[np.unique(block)] = True
    mtf = np.flatnonzero(used).tolist()  # mtf[rank] = byte value
    eob = len(mtf) + 1
    out: list[int] = []
    zeros = 0
    for b in block.tolist():
        r = mtf.index(b)
        if r == 0:
            zeros += 1
            continue
        if zeros:
            out.extend(zero_run_digits(zeros))
            zeros = 0
        out.append(r + 1)
        mtf.pop(r)
        mtf.insert(0, b)
    if zeros:
        out.extend(zero_run_digits(zeros))
    out.append(eob)
    rle2 = np.asarray(out, dtype=np.uint16)
    freqs = np.bincount(rle2, minlength=258).astype(np.uint32)
    return rle2, freqs, used


def mtf_rle2_decode(rle2: np.ndarray, symbol_set: np.ndarray, max_size: int) -> np.ndarray:
    """The inverse: RLE2 symbols (up to the EOB, or without it) and the
    sorted byte values in use -> at most ``max_size`` bytes. Raises on more
    zeros than ZERO_BOMB in one run or more bytes than ``max_size``."""
    symbol_set = np.asarray(symbol_set, dtype=np.uint8)
    eob = symbol_set.size + 1
    mtf = symbol_set.tolist()
    out = np.empty(max_size, dtype=np.uint8)
    pos = 0
    zeros = 0
    bit_mult = 1
    for s in np.asarray(rle2, dtype=np.int64).tolist():
        if s <= 1:  # RUNA / RUNB
            zeros += bit_mult * (s + 1)
            bit_mult <<= 1
            if zeros > ZERO_BOMB:
                raise ValueError("zero-run bomb in RLE2 stream")
            continue
        if zeros:
            if pos + zeros > max_size:
                raise ValueError("RLE2 output exceeds block size")
            out[pos: pos + zeros] = mtf[0]
            pos += zeros
            zeros = 0
            bit_mult = 1
        if s == eob:
            break
        b = mtf.pop(s - 1)
        mtf.insert(0, b)
        if pos >= max_size:
            raise ValueError("RLE2 output exceeds block size")
        out[pos] = b
        pos += 1
    if zeros:
        if pos + zeros > max_size:
            raise ValueError("RLE2 output exceeds block size")
        out[pos: pos + zeros] = mtf[0]
        pos += zeros
    return out[:pos]

"""The two-level symbol presence map of a block header.

The counterpart of ``tpubz/format/symbol_map.py``: a 16-bit word of the
16-symbol groups in use, then one 16-bit word for each group in use, MSB
first (the bit of group or symbol 0 is the top bit).
"""
from __future__ import annotations

import numpy as np


def encode_symbol_map(used: np.ndarray) -> list[int]:
    """``used``: bool[256] presence flags -> [L1 word, L2 words...] (ints)."""
    used = np.asarray(used, dtype=bool)
    l1 = 0
    l2 = [0] * 16
    for idx in np.flatnonzero(used):
        idx = int(idx)
        l1 |= 0x8000 >> (idx >> 4)
        l2[idx >> 4] |= 0x8000 >> (idx & 15)
    return [l1] + [w for w in l2 if w]


def decode_symbol_map(words: list[int]) -> np.ndarray:
    """[L1, L2...] words -> sorted uint8 array of the byte values in use."""
    l1 = words[0]
    syms = []
    wi = 1
    for g in range(16):
        if l1 & (0x8000 >> g):
            w = words[wi]
            wi += 1
            for b in range(16):
                if w & (0x8000 >> b):
                    syms.append((g << 4) | b)
    return np.array(syms, dtype=np.uint8)

"""The Burrows-Wheeler transform of a block's rotations in numpy, for the
scalar codec.

The counterpart of ``tpubz/hostref/bwt.py``, and like it written apart from
the card's kernels and the native engine. The forward transform sorts the n
rotations by prefix doubling over ranks mod n, each round an
``np.lexsort``, and returns the last column and the sorted position of
rotation 0 (the key). The inverses follow the next pointers of a stable
counting sort of the last column: one step at a time (``bwt_decode``), or
by doubling jumps (``bwt_decode_fast``).
"""
from __future__ import annotations

import numpy as np


def bwt_encode(data: np.ndarray) -> tuple[int, np.ndarray]:
    """(key, last column) of ``data``'s rotations."""
    d = np.asarray(data, dtype=np.uint8)
    n = d.size
    if n <= 1:
        return 0, d.copy()
    rank = d.astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while k < n:
        rank2 = rank[(idx + k) % n]
        order = np.lexsort((rank2, rank))
        r_sorted = rank[order]
        r2_sorted = rank2[order]
        neq = np.empty(n, dtype=np.int64)
        neq[0] = 0
        neq[1:] = (np.diff(r_sorted) != 0) | (np.diff(r2_sorted) != 0)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.cumsum(neq)
        if rank[order[-1]] == n - 1:
            break
        k <<= 1
    # ties left are equal rotations (a periodic block): any order gives the
    # same last column, and the key takes rotation 0's place with ties
    # broken by index
    sa = np.lexsort((idx, rank))
    key = int(np.flatnonzero(sa == 0)[0])
    return key, d[(sa - 1) % n]


def bwt_decode(key: int, last: np.ndarray) -> np.ndarray:
    """The block of a last column and its key, one pointer step a byte."""
    L = np.asarray(last, dtype=np.uint8)
    n = L.size
    if n == 0:
        return L.copy()
    order = np.argsort(L, kind="stable")  # row i of the sorted first column
    out = np.empty(n, dtype=np.uint8)
    p = order[key]
    for i in range(n):
        out[i] = L[p]
        p = order[p]
    return out


def bwt_decode_fast(key: int, last: np.ndarray) -> np.ndarray:
    """``bwt_decode`` by pointer doubling: the key's orbit under the next
    pointers, the positions filled twice as far each step."""
    L = np.asarray(last, dtype=np.uint8)
    n = L.size
    if n == 0:
        return L.copy()
    nxt = np.argsort(L, kind="stable").astype(np.int64)
    positions = np.empty(n, dtype=np.int64)
    positions[0] = nxt[key]
    filled = 1
    jump = nxt.copy()  # nxt applied `filled` times
    while filled < n:
        take = min(filled, n - filled)
        positions[filled: filled + take] = jump[positions[:take]]
        filled += take
        if filled < n:
            jump = jump[jump]
    return L[positions]

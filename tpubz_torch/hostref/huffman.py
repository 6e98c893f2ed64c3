"""Huffman table seeding, canonical codes, selector MTF and block headers.

The counterpart of the parts of ``tpubz/hostref/huffman.py`` that the
device refine encoder (``block/encode.py:encode_block_devrefine``) runs on
the host: C bzip2's initial tables (``c_init_tables``), the canonical codes
of a table (``canonical_codes``), the move-to-front of the selectors
(``mtf_selectors``, on the native engine) and everything a block emits
before its payload (``huffman_emit_headers``). The code lengths of each
refinement pass come from ``native.code_lengths_native``. tpubz's numpy
code-length functions, its refinement oracle and its decoder have no copy
here: the port's refinement and decoding run in its native engine.
"""
from __future__ import annotations

import numpy as np

from ..format.symbol_map import encode_symbol_map
from ..native import mtf_selectors_native
from .bitio import BitAccum


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes, assigned in ascending (length, symbol) order."""
    lengths = np.asarray(lengths, dtype=np.int64)
    alpha = lengths.size
    order = np.lexsort((np.arange(alpha), lengths))
    codes = np.zeros(alpha, dtype=np.int64)
    code = 0
    prev_len = int(lengths[order[0]])
    for s in order:
        n = int(lengths[s])
        if n != prev_len:
            code <<= n - prev_len
            prev_len = n
        codes[s] = code
        code += 1
    return codes


def c_init_tables(freqs: np.ndarray, table_count: int, alpha: int) -> np.ndarray:
    """C bzip2's initial tables: int64[6, 258] of lengths 0 (a symbol in the
    table's share of the frequencies) and 15, the shares cut from what
    remains, each other table's end backed up by one symbol."""
    tables = np.full((6, 258), 15, dtype=np.int64)
    gs = 0
    n_part = table_count
    rem_f = int(freqs[:alpha].sum())
    while n_part > 0:
        t_freq = rem_f // n_part
        ge = gs - 1
        a_freq = 0
        while a_freq < t_freq and ge < alpha - 1:
            ge += 1
            a_freq += int(freqs[ge])
        if (
            ge > gs
            and n_part != table_count
            and n_part != 1
            and (table_count - n_part) % 2 == 1
        ):
            a_freq -= int(freqs[ge])
            ge -= 1
        tables[n_part - 1, gs: ge + 1] = 0
        n_part -= 1
        gs = ge + 1
        rem_f -= a_freq
    return tables


def mtf_selectors(selectors: np.ndarray) -> np.ndarray:
    """The move-to-front indices of the selectors (native engine): int64."""
    return mtf_selectors_native(np.asarray(selectors))


def huffman_emit_headers(
    acc: BitAccum,
    used: np.ndarray,
    selectors: np.ndarray,
    lengths: np.ndarray,
    table_count: int,
) -> np.ndarray:
    """Emit everything before the payload: the symbol map, the table count,
    the selector count, the selectors (MTF, then unary) and each table's
    delta-coded lengths. Returns the canonical codes[table_count, alpha]."""
    alpha = int(np.asarray(used, bool).sum()) + 2
    for w in encode_symbol_map(used):
        acc.put(w, 16)
    acc.put(table_count, 3)
    acc.put(selectors.size, 15)
    # selector m emits m ones and a zero
    m = mtf_selectors(selectors)
    acc.extend(((1 << m) - 1) << 1, m + 1)
    # per table: a 5-bit origin, then for each symbol |d| repetitions of
    # '10' (d > 0) or '11' (d < 0) and a '0', as closed-form patterns
    # ('10' * k = 2 * (4^k - 1) / 3, '11' * k = 4^k - 1) in two fields of at
    # most 24 bits (|d| <= 19 can need 39 bits)
    codes = np.zeros((table_count, alpha), dtype=np.int64)
    for t in range(table_count):
        lens = np.asarray(lengths[t][:alpha], dtype=np.int64)
        codes[t] = canonical_codes(lens)
        acc.put(int(lens[0]), 5)
        d = np.empty(alpha, dtype=np.int64)
        d[0] = 0
        d[1:] = lens[1:] - lens[:-1]
        ad = np.abs(d)
        k1 = np.minimum(ad, 11)
        k2 = ad - k1

        def pat(k):
            p = (np.int64(1) << (2 * k)) - 1
            return np.where(d > 0, p // 3 * 2, p)

        v1, b1 = pat(k1), 2 * k1
        v2, b2 = pat(k2) << 1, 2 * k2 + 1  # the terminator rides field 2
        vals = np.stack([v1, v2], axis=1).ravel()
        bits = np.stack([b1, b2], axis=1).ravel()
        keep = bits > 0
        acc.extend(vals[keep], bits[keep])
    return codes

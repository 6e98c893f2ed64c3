"""Multi-table canonical Huffman coding on the host: the tables, the
refinement, the emission and the decoder.

The counterpart of ``tpubz/hostref/huffman.py``. Two users share it:
- the device refine encoder (``block/encode.py:encode_block_devrefine``)
  takes C bzip2's initial tables (``c_init_tables``), the canonical codes
  (``canonical_codes``), the selectors' move-to-front on the native engine
  (``mtf_selectors``) and the headers (``huffman_emit_headers``); its code
  lengths come from ``native.code_lengths_native``;
- the scalar codec (``hostref/block.py``) runs numpy and Python only, none
  of the native engine: the code-length functions (``code_lengths_from_freqs``,
  C bzip2's heap in ``c_code_lengths``), the refinement
  (``assign_selectors_and_lengths``, ``refine_from_hist``; tpubz's
  ``refine_stream`` without its native branch), ``mtf_selectors_numpy``,
  the emission (``huffman_encode``, ``huffman_emit``) and the decoder
  (``read_huffman_tables``, ``build_decode_table``,
  ``huffman_decode_payload``).
The header fields and, when asked, every decoded symbol log their bit
position at DEBUG on the ``tpubz_torch`` logger, in tpubz's words.
"""
from __future__ import annotations

import heapq
import logging

import numpy as np

from ..format.constants import (
    GROUP_SIZE,
    MAX_CODE_LEN_DECODE,
    MAX_CODE_LEN_ENCODE,
    group_count_for,
    huffman_iters,
)
from ..format.symbol_map import encode_symbol_map
from ..native import mtf_selectors_native
from .bitio import BitAccum, BitReader

log = logging.getLogger("tpubz_torch")


# ---------------------------------------------------------------------------
# code lengths and codes
# ---------------------------------------------------------------------------

def code_lengths_from_freqs(freqs: np.ndarray, alpha: int,
                            max_len: int = MAX_CODE_LEN_ENCODE) -> np.ndarray:
    """Depth-limited Huffman code lengths of symbols 0..alpha-1: a tree on
    weights (weight << 8 | depth); while a depth exceeds ``max_len``, the
    weights flatten to w // 2 + 1 and the tree is built again."""
    w = np.asarray(freqs[:alpha], dtype=np.int64)
    weight = np.where(w == 0, 1, w)
    while True:
        lens = _tree_depths(weight)
        if lens.max() <= max_len:
            return lens
        weight = weight // 2 + 1


def _tree_depths(weight: np.ndarray) -> np.ndarray:
    """The leaf depths of a Huffman tree on int64 weights >= 1."""
    alpha = weight.size
    if alpha == 1:
        return np.array([1], dtype=np.int64)
    heap = [(int(wi) << 8, i) for i, wi in enumerate(weight)]
    heapq.heapify(heap)
    parent = np.full(2 * alpha, -1, dtype=np.int64)
    next_id = alpha
    while len(heap) > 1:
        w1, n1 = heapq.heappop(heap)
        w2, n2 = heapq.heappop(heap)
        packed = ((w1 & ~0xFF) + (w2 & ~0xFF)) | (1 + max(w1 & 0xFF, w2 & 0xFF))
        parent[n1] = next_id
        parent[n2] = next_id
        heapq.heappush(heap, (packed, next_id))
        next_id += 1
    depths = np.zeros(alpha, dtype=np.int64)
    for i in range(alpha):
        d = 0
        j = i
        while parent[j] >= 0:
            j = parent[j]
            d += 1
        depths[i] = d
    return depths


def c_code_lengths(freqs: np.ndarray, alpha: int,
                   max_len: int = MAX_CODE_LEN_ENCODE) -> np.ndarray:
    """C bzip2's BZ2_hbMakeCodeLengths: a binary heap ordered by
    (weight << 8 | depth) and the flattening retry, so that ties break as
    C's do and the output's size is C's."""
    freqs = np.asarray(freqs[:alpha], dtype=np.int64)
    weight = np.zeros(alpha * 2 + 2, dtype=np.int64)
    heap = np.zeros(alpha + 2, dtype=np.int64)
    parent = np.zeros(alpha * 2 + 2, dtype=np.int64)
    weight[1: alpha + 1] = np.where(freqs == 0, 1, freqs) << 8

    def upheap(zz):
        tmp = heap[zz]
        while weight[tmp] < weight[heap[zz >> 1]]:
            heap[zz] = heap[zz >> 1]
            zz >>= 1
        heap[zz] = tmp

    def downheap(n_heap):
        zz = 1
        tmp = heap[zz]
        while True:
            yy = zz << 1
            if yy > n_heap:
                break
            if yy < n_heap and weight[heap[yy + 1]] < weight[heap[yy]]:
                yy += 1
            if weight[tmp] < weight[heap[yy]]:
                break
            heap[zz] = heap[yy]
            zz = yy
        heap[zz] = tmp

    lens = np.zeros(alpha, dtype=np.int64)
    while True:
        n_nodes = alpha
        n_heap = 0
        heap[0] = 0
        weight[0] = 0
        parent[0] = -2
        for i in range(1, alpha + 1):
            parent[i] = -1
            n_heap += 1
            heap[n_heap] = i
            upheap(n_heap)
        while n_heap > 1:
            n1 = heap[1]
            heap[1] = heap[n_heap]
            n_heap -= 1
            downheap(n_heap)
            n2 = heap[1]
            heap[1] = heap[n_heap]
            n_heap -= 1
            downheap(n_heap)
            n_nodes += 1
            parent[n1] = parent[n2] = n_nodes
            w1, w2 = weight[n1], weight[n2]
            weight[n_nodes] = ((w1 & ~0xFF) + (w2 & ~0xFF)) | (1 + max(w1 & 0xFF, w2 & 0xFF))
            parent[n_nodes] = -1
            n_heap += 1
            heap[n_heap] = n_nodes
            upheap(n_heap)
        too_long = False
        for i in range(1, alpha + 1):
            j = 0
            k = i
            while parent[k] >= 0:
                k = parent[k]
                j += 1
            lens[i - 1] = j
            if j > max_len:
                too_long = True
        if not too_long:
            return lens.copy()
        for i in range(1, alpha + 1):
            weight[i] = (1 + (weight[i] >> 8) // 2) << 8


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


# ---------------------------------------------------------------------------
# the refinement
# ---------------------------------------------------------------------------

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


def mtf_selectors_numpy(selectors: np.ndarray) -> np.ndarray:
    """``mtf_selectors`` by list moves, without the native engine."""
    idx = list(range(6))
    out = np.empty(np.size(selectors), dtype=np.int64)
    for i, s in enumerate(np.asarray(selectors, dtype=np.int64).tolist()):
        r = idx.index(s)
        out[i] = r
        idx.pop(r)
        idx.insert(0, s)
    return out


def _exact_bits(chunk_hist, selectors, lengths, table_count, alpha, nsel):
    """The emitted size: the payload, the unary MTF'd selectors and the
    length deltas."""
    payload = int((chunk_hist * lengths[selectors, :alpha]).sum())
    sel_bits = int(mtf_selectors_numpy(selectors).sum()) + nsel
    dl = np.abs(np.diff(lengths[:table_count, :alpha], axis=1)).sum()
    return payload + sel_bits + int(dl) * 2 + table_count * (alpha + 5)


def assign_selectors_and_lengths(rle2: np.ndarray, freqs: np.ndarray, alpha: int
                                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """The refinement of a block's symbols in numpy (tpubz's
    ``refine_stream`` without its native branch): (selectors,
    lengths[6, alpha], table_count)."""
    rle2 = np.asarray(rle2, dtype=np.int64)
    nsel = (rle2.size + GROUP_SIZE - 1) // GROUP_SIZE
    # the (nsel, alpha) histogram of each 50-symbol group
    flat = np.arange(rle2.size, dtype=np.int64) // GROUP_SIZE * alpha + rle2
    chunk_hist = np.bincount(flat, minlength=nsel * alpha).reshape(nsel, alpha)
    return refine_from_hist(chunk_hist, rle2.size, freqs, alpha)


def refine_from_hist(chunk_hist: np.ndarray, rle2_len: int, freqs: np.ndarray, alpha: int
                     ) -> tuple[np.ndarray, np.ndarray, int]:
    """The refinement on the groups' histograms: from C bzip2's initial
    tables, each pass picks the cheapest table of every group and rebuilds
    each table's lengths with C's heap from its groups' sums. The best pass
    by exact emitted size is kept; past C's 4 passes the loop stops after
    one that does not improve."""
    table_count = group_count_for(rle2_len)
    nsel = chunk_hist.shape[0]
    tables = c_init_tables(freqs, table_count, alpha)
    best = None
    stale = 0
    for it in range(huffman_iters()):
        cost = chunk_hist @ tables[:table_count, :alpha].T  # (nsel, table_count)
        selectors = np.argmin(cost, axis=1)
        for t in range(table_count):
            tables[t, :alpha] = c_code_lengths(chunk_hist[selectors == t].sum(axis=0), alpha)
        total = _exact_bits(chunk_hist, selectors, tables, table_count, alpha, nsel)
        if best is None or total < best[0]:
            best = (total, selectors.copy(), tables[:, :alpha].copy())
            stale = 0
        else:
            stale += 1
        if it >= 3 and stale >= 1:
            break
    return best[1], best[2], table_count


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

def huffman_encode(acc: BitAccum, rle2: np.ndarray, freqs: np.ndarray, used: np.ndarray) -> None:
    """The scalar encoder's block body after the key: the symbol map, the
    tables, the selectors and the payload into ``acc``, in numpy."""
    alpha = int(np.asarray(used, bool).sum()) + 2
    selectors, lengths, table_count = assign_selectors_and_lengths(rle2, freqs, alpha)
    huffman_emit(acc, rle2, used, selectors, lengths, table_count)


def huffman_emit_headers(
    acc: BitAccum,
    used: np.ndarray,
    selectors: np.ndarray,
    lengths: np.ndarray,
    table_count: int,
    mtf=mtf_selectors,
) -> np.ndarray:
    """Emit everything before the payload: the symbol map, the table count,
    the selector count, the selectors (``mtf``, then unary) and each table's
    delta-coded lengths. Returns the canonical codes[table_count, alpha]."""
    alpha = int(np.asarray(used, bool).sum()) + 2
    log.debug("symbol map written at bit %d", acc.bit_len)
    for w in encode_symbol_map(used):
        acc.put(w, 16)
    log.debug("table count %d written at bit %d", table_count, acc.bit_len)
    acc.put(table_count, 3)
    log.debug("selector count %d written at bit %d", selectors.size, acc.bit_len)
    acc.put(selectors.size, 15)
    # selector m emits m ones and a zero
    m = mtf(selectors)
    acc.extend(((1 << m) - 1) << 1, m + 1)
    # per table: a 5-bit origin, then for each symbol |d| repetitions of
    # '10' (d > 0) or '11' (d < 0) and a '0', as closed-form patterns
    # ('10' * k = 2 * (4^k - 1) / 3, '11' * k = 4^k - 1) in two fields of at
    # most 24 bits (|d| <= 19 can need 39 bits)
    codes = np.zeros((table_count, alpha), dtype=np.int64)
    for t in range(table_count):
        lens = np.asarray(lengths[t][:alpha], dtype=np.int64)
        codes[t] = canonical_codes(lens)
        log.debug("table %d origin %d written at bit %d", t, int(lens[0]), acc.bit_len)
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


def huffman_emit(acc: BitAccum, rle2: np.ndarray, used: np.ndarray, selectors: np.ndarray,
                 lengths: np.ndarray, table_count: int) -> None:
    """The headers, then the payload: each symbol's code and length from
    its group's table, as fields, in numpy."""
    codes = huffman_emit_headers(acc, used, selectors, lengths, table_count,
                                 mtf=mtf_selectors_numpy)
    log.debug("payload (%d symbols) written at bit %d", rle2.size, acc.bit_len)
    rle2 = np.asarray(rle2, dtype=np.int64)
    sel_per_sym = np.repeat(selectors, GROUP_SIZE)[: rle2.size]
    acc.extend(codes[sel_per_sym, rle2].astype(np.uint32),
               np.asarray(lengths)[sel_per_sym, rle2].astype(np.int64))


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def read_huffman_tables(br: BitReader, alpha: int, table_count: int) -> np.ndarray:
    """Each table's delta-coded lengths -> lengths[table_count, alpha]."""
    lengths = np.zeros((table_count, alpha), dtype=np.int64)
    for t in range(table_count):
        cur = br.read(5)
        for s in range(alpha):
            while br.read_bit():
                cur += -1 if br.read_bit() else 1
            if not 1 <= cur <= MAX_CODE_LEN_DECODE:
                raise ValueError(f"invalid code length {cur}")
            lengths[t, s] = cur
    return lengths


def build_decode_table(lengths: np.ndarray) -> dict:
    """A canonical decode table: per length the first code (``base``), the
    last (``limit``) and the offset into the symbols in (length, symbol)
    order (``off``, ``syms``)."""
    alpha = lengths.size
    order = np.lexsort((np.arange(alpha), lengths))
    codes = canonical_codes(lengths)
    min_len = int(lengths.min())
    max_len = int(lengths.max())
    base = np.zeros(max_len + 2, dtype=np.int64)
    limit = np.full(max_len + 2, -1, dtype=np.int64)
    off = np.zeros(max_len + 2, dtype=np.int64)
    sorted_lens = lengths[order]
    pos = 0
    for n in range(min_len, max_len + 1):
        cnt = int((sorted_lens == n).sum())
        if cnt:
            base[n] = int(codes[order[pos]])
            off[n] = pos
            limit[n] = base[n] + cnt - 1
        else:
            # a length with no code: the limits stay monotone so the walk
            # goes past it
            prev_limit = limit[n - 1] if n > min_len else -1
            base[n] = (prev_limit + 1) << 1
            off[n] = pos
            limit[n] = base[n] - 1
        pos += cnt
    return {"min_len": min_len, "max_len": max_len, "base": base, "limit": limit,
            "off": off, "syms": order.astype(np.int64)}


def huffman_decode_payload(br: BitReader, tables: list[dict], selectors: np.ndarray, eob: int,
                           trace: bool = False) -> np.ndarray:
    """Decode symbols up to the EOB: uint16, the EOB left out. With
    ``trace``, each symbol logs its table, length and bit position."""
    out: list[int] = []
    group = -1
    g_left = 0
    t = None
    while True:
        if g_left == 0:
            group += 1
            if group >= selectors.size:
                raise ValueError("ran out of selectors before EOB")
            t = tables[int(selectors[group])]
            g_left = GROUP_SIZE
        g_left -= 1
        pos0 = br.pos
        n = t["min_len"]
        code = br.read(n)
        while code > t["limit"][n]:
            if n >= t["max_len"]:
                raise ValueError("invalid Huffman code in payload")
            code = (code << 1) | br.read_bit()
            n += 1
        sym = int(t["syms"][t["off"][n] + code - t["base"][n]])
        if trace:
            log.debug("sym %d (table %d, %d bits) read at bit %d",
                      sym, int(selectors[group]), n, pos0)
        if sym == eob:
            return np.asarray(out, dtype=np.uint16)
        out.append(sym)

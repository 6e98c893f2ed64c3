"""The plain reference: a whole bzip2 stream of the port's format in NumPy.

The judge of the benchmark's ``correct``. It imports nothing of the program
and takes nothing the program made: it is handed the same input bytes and
works out the stream again, byte for byte. Its steps are those of the
port's scalar codec, frozen here, with the slow loops vectorised:

- RLE1 and the block cuts by C bzip2's rule (runs of 4-255 become four
  literals and a count; a block closes at the segment that brings it to
  ``level * 100_000 - 19`` bytes);
- the BWT of each block's rotations by prefix doubling that sorts, after
  the first round (5 bytes), only the rotations whose class still has
  company; equal rotations of a periodic block in index order;
- MTF over the block's byte values in use, ascending, computed as the
  number of distinct symbols since each symbol's last use, and RLE2's
  zero runs in bijective base 2 (RUNA, RUNB), the EOB last;
- C bzip2's initial tables, then refinement passes (each group of 50
  symbols to its cheapest table, each table's lengths by C's heap), the
  smallest emitted size kept, stopping after the fourth pass at the first
  that does not shrink it, at most ``iters`` passes;
- the symbol map, tables, selectors and payload, the block and stream CRCs
  and the bits of every block spliced at bit granularity.

``compress`` runs the blocks on a few threads: NumPy's sorts and gathers
release the interpreter lock.
"""
from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BLOCK_MAGIC = 0x314159265359
FOOTER_MAGIC = 0x177245385090
RUN_THRESHOLD = 4
MAX_RUN = 255
GROUP_SIZE = 50
MAX_CODE_LEN = 17
ITERS = 8  # the port's refinement passes at most (C bzip2 runs 4)
_POS = (1 << 20) - 1  # a position or a rank of a block of < 2^20 bytes


def block_budget(level: int) -> int:
    return level * 100_000 - 19


def group_count_for(n_syms: int) -> int:
    for limit, tables in ((200, 2), (600, 3), (1200, 4), (2400, 5)):
        if n_syms < limit:
            return tables
    return 6


# ---------------------------------------------------------------------------
# RLE1 and the block cuts
# ---------------------------------------------------------------------------

def _ramp(lens: np.ndarray) -> np.ndarray:
    """0..len-1 for each len, concatenated."""
    starts = np.concatenate(([0], np.cumsum(lens)))[:-1]
    return np.arange(int(lens.sum())) - np.repeat(starts, lens)


def rle1_encode(data: np.ndarray):
    """(out, seg_out_start, seg_in_start): the RLE1 bytes and the output and
    input offsets of every run segment's start (the valid cuts), each list
    ending with its total."""
    n = data.size
    if n == 0:
        sent = np.zeros(1, np.int64)
        return np.zeros(0, np.uint8), sent, sent
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(data[1:], data[:-1], out=change[1:])
    run_starts = np.flatnonzero(change)
    run_lens = np.diff(np.concatenate((run_starts, [n])))
    q, f = np.divmod(run_lens, MAX_RUN)
    seg_cnt = q + (f > 0)
    seg_run = np.repeat(np.arange(run_starts.size), seg_cnt)
    seg_pos = _ramp(seg_cnt)
    is_last = seg_pos == seg_cnt[seg_run] - 1
    seg_len = np.where(is_last & (f[seg_run] > 0), f[seg_run], MAX_RUN)
    seg_in = run_starts[seg_run] + seg_pos * MAX_RUN
    lit_len = np.minimum(seg_len, RUN_THRESHOLD)
    has_cnt = seg_len >= RUN_THRESHOLD
    out_off = np.concatenate(([0], np.cumsum(lit_len + has_cnt)))
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    lit = _ramp(lit_len)
    out[np.repeat(out_off[:-1], lit_len) + lit] = data[np.repeat(seg_in, lit_len) + lit]
    cnt = np.flatnonzero(has_cnt)
    out[out_off[cnt] + RUN_THRESHOLD] = (seg_len[cnt] - RUN_THRESHOLD).astype(np.uint8)
    return (out, np.concatenate((out_off[:-1], [out.size])),
            np.concatenate((seg_in, [n])))


def split_blocks(seg_out: np.ndarray, seg_in: np.ndarray, budget: int):
    """[(out_lo, out_hi, in_lo, in_hi)]: a block closes at the end of the
    first segment that brings it to the budget, unless fewer than two input
    bytes follow, when the tail joins it."""
    if int(seg_out[-1]) == 0:
        return []
    blocks, i = [], 0
    nsegs, n = seg_out.size - 1, int(seg_in[-1])
    while i < nsegs:
        lo = int(seg_out[i])
        m = int(np.searchsorted(seg_out, lo + budget, side="left"))
        if m > nsegs or int(seg_in[m]) > n - 2:
            m = nsegs
        blocks.append((lo, int(seg_out[m]), int(seg_in[i]), int(seg_in[m])))
        i = m
    return blocks


# ---------------------------------------------------------------------------
# CRCs
# ---------------------------------------------------------------------------

_BITREV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8)


def block_crc(data: np.ndarray) -> int:
    """CRC-32/BZIP2 (MSB-first) through zlib's reflected CRC-32."""
    crc = zlib.crc32(_BITREV8[data].tobytes()) & 0xFFFF_FFFF
    return int(f"{crc:032b}"[::-1], 2)


def stream_crc_fold(s: int, crc: int) -> int:
    return (((s << 1) | (s >> 31)) & 0xFFFF_FFFF) ^ crc


# ---------------------------------------------------------------------------
# BWT
# ---------------------------------------------------------------------------

def _group_starts(keys: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """The slot of each sorted key's first equal."""
    first = np.empty(keys.size, bool)
    first[0] = True
    np.not_equal(keys[1:], keys[:-1], out=first[1:])
    st = np.where(first, slots, 0)
    return np.maximum.accumulate(st)


def bwt(block: np.ndarray) -> tuple[int, np.ndarray, int]:
    """(key, last column, doubling rounds) of ``block``'s rotations; the key
    is rotation 0's slot, equal rotations in index order."""
    n = block.size
    if n <= 1:
        return 0, block.copy(), 0
    if n > _POS:
        raise ValueError("a block has fewer than 2^20 bytes")
    idx = np.arange(n, dtype=np.int64)
    first = 5
    ext = np.concatenate([block] * (first // n + 2)).astype(np.int64)
    key = np.zeros(n, np.int64)
    for k in range(first):
        key = (key << 8) | ext[k:k + n]
    packed = np.sort((key << 20) | idx)
    sa = packed & _POS
    st = _group_starts(packed >> 20, idx)
    rank = np.empty(n, np.int64)
    rank[sa] = st
    act, h, rounds = idx, first, 1
    while True:
        # slots whose class still has company
        keep = np.zeros(act.size, bool)
        eq = st[1:] == st[:-1]
        keep[1:] |= eq
        keep[:-1] |= eq
        act, st = act[keep], st[keep]
        if act.size == 0 or h >= n:
            break
        pos = sa[act]
        packed = np.sort((st << 40) | (rank[(pos + h) % n] << 20) | pos)
        pos = packed & _POS
        sa[act] = pos
        st = _group_starts(packed >> 20, act)
        rank[pos] = st
        h *= 2
        rounds += 1
    if act.size:
        sa[act] = np.sort((st << 20) | sa[act]) & _POS
    return int(np.flatnonzero(sa == 0)[0]), block[(sa - 1) % n], rounds


# ---------------------------------------------------------------------------
# MTF and RLE2
# ---------------------------------------------------------------------------

def mtf_rle2(last: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(RLE2 symbols int64 with the EOB last, used bool[256]) of a last
    column."""
    used = np.zeros(256, bool)
    used[last] = True
    lut = np.cumsum(used) - 1
    x = lut[last]
    m = int(used.sum())
    n = x.size
    # runs of one symbol: only a run's first position has a rank above 0
    head = np.empty(n, bool)
    head[0] = True
    np.not_equal(x[1:], x[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    y = x[starts]
    run_len = np.diff(np.append(starts, n))
    R = y.size
    j = np.arange(R, dtype=np.int64)
    # each run's symbol's previous run, or its place in the initial list as
    # a time before the block (the front, index 0, at -1)
    order = np.argsort(y, kind="stable")
    prev = np.empty(R, np.int64)
    ys = y[order]
    new_sym = np.empty(R, bool)
    new_sym[0] = True
    np.not_equal(ys[1:], ys[:-1], out=new_sym[1:])
    prev_sorted = np.empty(R, np.int64)
    prev_sorted[1:] = order[:-1]
    prev_sorted[new_sym] = -(ys[new_sym] + 1)
    prev[order] = prev_sorted
    # rank = the symbols used since then: those whose last use before j is
    # later than prev[j]
    rank = np.zeros(R, np.int64)
    for s in range(m):
        last_use = np.where(y == s, j, -(s + 1))
        np.maximum.accumulate(last_use, out=last_use)
        before = np.empty(R, np.int64)
        before[0] = -(s + 1)
        before[1:] = last_use[:-1]
        rank += before > prev
    # per run: the head's symbol rank + 1 (none for rank 0), then the zero
    # run of its other positions in bijective base 2, low digit first
    zeros = run_len - (rank > 0)
    ndig = np.where(zeros > 0, np.frexp((zeros + 1).astype(np.float64))[1] - 1, 0)
    lit = (rank > 0).astype(np.int64)
    off = np.concatenate(([0], np.cumsum(lit + ndig)))
    out = np.empty(int(off[-1]) + 1, np.int64)
    hl = np.flatnonzero(lit)
    out[off[hl]] = rank[hl] + 1
    run_of = np.repeat(j, ndig)
    k = _ramp(ndig)
    out[off[run_of] + lit[run_of] + k] = ((zeros[run_of] + 1) >> k) & 1
    out[-1] = m + 1
    return out, used


# ---------------------------------------------------------------------------
# Huffman tables and the refinement
# ---------------------------------------------------------------------------

def c_code_lengths(freqs, alpha: int) -> list[int]:
    """C bzip2's BZ2_hbMakeCodeLengths: a binary heap ordered by
    (weight << 8 | depth), ties as C's, and while a code exceeds 17 bits the
    weights flattened to 1 + w / 2 and the tree built again."""
    weight = [0] * (alpha * 2 + 2)
    heap = [0] * (alpha + 2)
    parent = [0] * (alpha * 2 + 2)
    for i in range(alpha):
        f = int(freqs[i])
        weight[i + 1] = (f if f else 1) << 8
    while True:
        n_nodes, n_heap = alpha, 0
        heap[0] = weight[0] = 0
        parent[0] = -2
        for i in range(1, alpha + 1):
            parent[i] = -1
            n_heap += 1
            heap[n_heap] = i
            zz, tmp = n_heap, i
            while weight[tmp] < weight[heap[zz >> 1]]:
                heap[zz] = heap[zz >> 1]
                zz >>= 1
            heap[zz] = tmp
        while n_heap > 1:
            pair = []
            for _ in range(2):
                pair.append(heap[1])
                heap[1] = heap[n_heap]
                n_heap -= 1
                zz, tmp = 1, heap[1]
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
            n1, n2 = pair
            n_nodes += 1
            parent[n1] = parent[n2] = n_nodes
            w1, w2 = weight[n1], weight[n2]
            weight[n_nodes] = ((w1 & ~0xFF) + (w2 & ~0xFF)) | (1 + max(w1 & 0xFF, w2 & 0xFF))
            parent[n_nodes] = -1
            n_heap += 1
            heap[n_heap] = n_nodes
            zz, tmp = n_heap, n_nodes
            while weight[tmp] < weight[heap[zz >> 1]]:
                heap[zz] = heap[zz >> 1]
                zz >>= 1
            heap[zz] = tmp
        lens, too_long = [], False
        for i in range(1, alpha + 1):
            d, k = 0, i
            while parent[k] >= 0:
                k = parent[k]
                d += 1
            lens.append(d)
            too_long |= d > MAX_CODE_LEN
        if not too_long:
            return lens
        for i in range(1, alpha + 1):
            weight[i] = (1 + (weight[i] >> 8) // 2) << 8


def c_init_tables(freqs: np.ndarray, table_count: int, alpha: int) -> np.ndarray:
    """C bzip2's initial tables: lengths 0 for a table's share of the
    frequencies and 15 elsewhere, each other table's end backed up by one."""
    tables = np.full((6, alpha), 15, dtype=np.int64)
    gs, n_part, rem_f = 0, table_count, int(freqs[:alpha].sum())
    while n_part > 0:
        t_freq = rem_f // n_part
        ge, a_freq = gs - 1, 0
        while a_freq < t_freq and ge < alpha - 1:
            ge += 1
            a_freq += int(freqs[ge])
        if ge > gs and n_part not in (table_count, 1) and (table_count - n_part) % 2 == 1:
            a_freq -= int(freqs[ge])
            ge -= 1
        tables[n_part - 1, gs:ge + 1] = 0
        n_part -= 1
        gs = ge + 1
        rem_f -= a_freq
    return tables


def mtf_selectors(selectors) -> list[int]:
    idx, out = list(range(6)), []
    for s in selectors:
        r = idx.index(s)
        out.append(r)
        del idx[r]
        idx.insert(0, s)
    return out


def refine(syms: np.ndarray, alpha: int, iters: int):
    """(selectors, lengths[table_count, alpha], table_count): from C's
    initial tables, passes that pick each group's cheapest table and rebuild
    the tables; the pass of the smallest emitted size is kept; the passes
    stop after the fourth at the first that does not shrink it."""
    nsel = -(-syms.size // GROUP_SIZE)
    hist = np.bincount(np.arange(syms.size) // GROUP_SIZE * alpha + syms,
                       minlength=nsel * alpha).reshape(nsel, alpha)
    tc = group_count_for(syms.size)
    freqs = np.bincount(syms, minlength=alpha)
    tables = c_init_tables(freqs, tc, alpha)[:tc]
    best, stale = None, 0
    for it in range(iters):
        sel = np.argmin(hist @ tables.T, axis=1)
        for t in range(tc):
            tables[t] = c_code_lengths(hist[sel == t].sum(axis=0), alpha)
        sel_list = sel.tolist()
        size = (int((hist * tables[sel]).sum()) + sum(mtf_selectors(sel_list)) + nsel
                + 2 * int(np.abs(np.diff(tables, axis=1)).sum()) + tc * (alpha + 5))
        if best is None or size < best[0]:
            best, stale = (size, sel_list, tables.copy()), 0
        else:
            stale += 1
        if it >= 3 and stale >= 1:
            break
    return best[1], best[2], tc


def canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Codes assigned in ascending (length, symbol) order."""
    order = np.lexsort((np.arange(lens.size), lens))
    codes = np.zeros(lens.size, np.int64)
    code, prev = 0, int(lens[order[0]])
    for s in order.tolist():
        if lens[s] != prev:
            code <<= int(lens[s]) - prev
            prev = int(lens[s])
        codes[s] = code
        code += 1
    return codes


# ---------------------------------------------------------------------------
# bits
# ---------------------------------------------------------------------------

def _bits(vals, widths) -> np.ndarray:
    """Fields MSB first as one uint8 array of bits."""
    vals = np.asarray(vals, np.int64)
    widths = np.asarray(widths, np.int64)
    k = _ramp(widths)
    return ((np.repeat(vals, widths) >> (np.repeat(widths, widths) - 1 - k)) & 1).astype(np.uint8)


def encode_block(block: np.ndarray, crc: int, iters: int = ITERS) -> np.ndarray:
    """One RLE1 block's bits, its magic first."""
    key, last, _ = bwt(block)
    syms, used = mtf_rle2(last)
    alpha = int(used.sum()) + 2
    sel, lens, tc = refine(syms, alpha, iters)
    vals, widths = [BLOCK_MAGIC >> 24, BLOCK_MAGIC & 0xFFFFFF, crc >> 16, crc & 0xFFFF, 0, key], \
        [24, 24, 16, 16, 1, 24]
    hi = [int(used[16 * i:16 * i + 16].any()) for i in range(16)]
    vals.append(int("".join(map(str, hi)), 2))
    widths.append(16)
    for i in range(16):
        if hi[i]:
            vals.append(int("".join(str(int(b)) for b in used[16 * i:16 * i + 16]), 2))
            widths.append(16)
    vals += [tc, len(sel)]
    widths += [3, 15]
    for m in mtf_selectors(sel):
        vals.append(((1 << m) - 1) << 1)
        widths.append(m + 1)
    for t in range(tc):
        vals.append(int(lens[t, 0]))
        widths.append(5)
        cur = int(lens[t, 0])
        for s in range(alpha):
            target = int(lens[t, s])
            while cur < target:
                vals.append(2)
                widths.append(2)
                cur += 1
            while cur > target:
                vals.append(3)
                widths.append(2)
                cur -= 1
            vals.append(0)
            widths.append(1)
    head = _bits(vals, widths)
    codes = np.stack([canonical_codes(lens[t]) for t in range(tc)])
    per_sym = np.repeat(np.asarray(sel, np.int64), GROUP_SIZE)[:syms.size]
    return np.concatenate((head, _bits(codes[per_sym, syms], lens[per_sym, syms])))


def compress(data, level: int = 9, iters: int = ITERS, workers: int = 8) -> bytes:
    """The bzip2 stream of ``data`` at ``level``, as the port writes it."""
    arr = np.frombuffer(bytes(data), np.uint8) if not isinstance(data, np.ndarray) else data
    out, seg_out, seg_in = rle1_encode(arr)
    blocks = split_blocks(seg_out, seg_in, block_budget(level))
    crcs = [block_crc(arr[i0:i1]) for _, _, i0, i1 in blocks]

    def one(b):
        o0, o1, _, _ = blocks[b]
        return encode_block(out[o0:o1], crcs[b], iters)

    with ThreadPoolExecutor(max(1, min(workers, len(blocks)))) as ex:
        bodies = list(ex.map(one, range(len(blocks))))
    s_crc = 0
    for c in crcs:
        s_crc = stream_crc_fold(s_crc, c)
    head = _bits([0x42, 0x5A, 0x68, 0x30 + level], [8] * 4)
    foot = _bits([FOOTER_MAGIC >> 24, FOOTER_MAGIC & 0xFFFFFF, s_crc >> 16, s_crc & 0xFFFF],
                 [24, 24, 16, 16])
    return np.packbits(np.concatenate([head, *bodies, foot])).tobytes()

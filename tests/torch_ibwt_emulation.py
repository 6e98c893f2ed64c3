"""csrc/ibwt.cu's inverse BWT emulated in numpy, kernel by kernel, with the
kernels' index math (the CUDA kernels run only on the card).

``splitter_inverse`` runs the next pointers (a stable sort; row u's sorted
key holds nxt[u] and its byte), ``walk_rows``' level-1 walks (each keeping
its segment's first ``kept`` bytes and the row it reached there),
``walk_list``'s level-2 walks, ``rank_top`` (the level-2 nodes walked from
the level-3 splitters in place, the level-3 nodes from the level-4 ones,
the level-4 list cut before p_0's node and ranked by pointer doubling in
rounds of reads then writes, the offsets down the levels), and
``write_orbit``'s words of each level-1 segment of p_0's cycle (each
4-byte word whole by the segment it starts in: the kept bytes, a walk on
from the row reached, the next segments' first bytes) and periodic fill,
each level's walkers in a random order. ``logs`` are log2 of the windows of rows, of
level-1 nodes and of the top's levels 3 and 4 (the kernels' are
``ibwt.LOG_D``; 0 makes every row, or node, a splitter);
``rows_picked=False`` picks no row at level 1, so p_0 is the only level-1
splitter and its walk is its whole cycle. Returns (out, record), the record
by ``tpubz_torch.kernels.ibwt.RECORD``'s names.
"""
import numpy as np

GOLDEN = 0x9E3779B1
POS_MASK = (1 << 20) - 1
MARK = 1 << 31
NONE = 0xFFFFFFFF
VISITED = 1 << 30
NIL = 0x7FFFFFFF


def pick(w: int, log: int) -> int:
    """The offset of window w's splitter in its window of 2^log."""
    return 0 if log == 0 else ((w * GOLDEN) & 0xFFFFFFFF) >> (32 - log)


def picked(x: int, log: int) -> bool:
    return (x & ((1 << log) - 1)) == pick(x >> log, log)


def slot_of(x: int, start: int, log: int, windows: int, picks=picked) -> int:
    return windows if x == start and not picks(x, log) else x >> log


def levels(n: int, logs):
    """(windows, slots) of each of the three levels."""
    out, m = [], n
    for log in logs:
        w = (m + (1 << log) - 1) >> log
        out.append((w, w + 1))
        m = w + 1
    return out


def next_pointers(last: np.ndarray, n: int) -> np.ndarray:
    sym = np.where(np.arange(last.size) < n, last.astype(np.int64), 256)
    return np.argsort(sym, kind="stable").astype(np.int64)


def _walk(start, read, write, rows_of):
    """One walker: visit nodes from start until a word marks its target;
    ``read(u)`` -> (word, rows), ``write(u, at)`` records the node at ``at``
    rows (or steps) into the segment. Returns (successor, rows, nodes)."""
    u, rows, nodes = start, 0, 0
    while True:
        word, w = read(u)
        write(u, rows)
        rows += rows_of(w)
        nodes += 1
        u = word & ~MARK & 0xFFFFFFFF
        if word & MARK:
            return u, rows, nodes


def splitter_inverse(key: int, last: np.ndarray, n: int, logs=(3, 3, 3), rows_picked=True,
                     rng=None, kept=64):
    rng = rng or np.random.default_rng(0)
    rec = dict.fromkeys(("launches", "splitters", "segments", "longest", "orbit",
                         "list_splitters", "list_longest", "top_splitters"), 0)
    if n == 0:
        return np.zeros(0, np.uint8), rec
    l1, l2, l3 = logs
    (w1, m1), (w2, m2), _ = levels(n, logs)

    def picks1(x, log):
        return rows_picked and picked(x, log)

    nxt = next_pointers(last, n)
    # the sorted keys: row u's is last[nxt[u]] << 20 | nxt[u]
    sorted_keys = (last[nxt[:n]].astype(np.int64) << 20) | nxt[:n]

    def slot_row(w, p0):
        if w < w1:
            u = (w << l1) + pick(w, l1)
            return u, rows_picked and u < n
        return p0, not picks1(p0, l1)

    # walk_rows: one gather a step; the first `kept` bytes kept, a word at a
    # time, and the row reached there
    rec["launches"] += 1
    p0 = int(sorted_keys[key]) & POS_MASK
    k0 = slot_of(p0, p0, l1, w1, picks1)
    node1 = np.zeros((m1, 2), np.int64)
    rec1 = np.zeros((m1, 2), np.int64)
    kept_bytes = np.zeros((m1, kept), np.int64)
    resume = np.zeros(m1, np.int64)
    for w in rng.permutation(m1):
        w = int(w)
        u, used = slot_row(w, p0)
        rec1[w] = (-1, 0)
        node1[w] = (NONE, 0)
        if not used:
            continue
        b, length = int(last[u]), 0
        while True:
            if length < kept:
                kept_bytes[w, length] = b
            word = int(sorted_keys[u])
            t = word & POS_MASK
            length += 1
            if t == p0 or picks1(t, l1):
                break
            u, b = t, (word >> 20) & 0xFF
            if length == kept:
                resume[w] = u
        s = slot_of(t, p0, l1, w1, picks1)
        node1[w] = (s | (MARK if picked(s, l2) or s == k0 else 0), length)
        rec["splitters"] += 1
        rec["longest"] = max(rec["longest"], length)

    # walk_list
    rec["launches"] += 1
    j0 = slot_of(k0, k0, l2, w2)
    node2 = np.zeros((m2, 2), np.int64)
    for j in rng.permutation(m2):
        j = int(j)
        if j < w2:
            u = (j << l2) + pick(j, l2)
            used = u < m1 and node1[u, 1] > 0
        else:
            u, used = k0, not picked(k0, l2)
        node2[j] = (NONE, 0)
        if not used:
            continue

        def write_node(k, at, j=j):
            rec1[k] = (j, at)

        succ, rows, nodes = _walk(u, lambda k: (int(node1[k, 0]), int(node1[k, 1])), write_node,
                                  lambda x: x)
        s = slot_of(succ, k0, l2, w2)
        node2[j] = (s | (MARK if picked(s, l3) or s == j0 else 0), rows)
        rec["list_splitters"] += 1
        rec["list_longest"] = max(rec["list_longest"], nodes)

    # rank_top: the level-2 nodes walked in place from the level-3
    # splitters, the level-3 nodes from the level-4 ones, the level-4 list
    # cut before p_0's node and ranked by doubling, the offsets down
    rec["launches"] += 1

    def walk_shared(below, m, start, last):
        windows = (m + (1 << l3) - 1) >> l3
        s0 = slot_of(start, start, l3, windows)
        above = np.zeros((windows + 1, 2), np.int64)
        for i in rng.permutation(windows + 1):
            i = int(i)
            if i < windows:
                u = (i << l3) + pick(i, l3)
                used = u < m and below[u, 1] > 0
            else:
                u, used = start, not picked(start, l3)
            above[i] = (i, 0) if last else (NONE, 0)
            if not used:
                continue

            def visit(q, at, i=i):
                below[q] = (i | VISITED, at)

            succ, rows, _ = _walk(u, lambda q: (int(below[q, 0]), int(below[q, 1])), visit,
                                  lambda x: x)
            s = slot_of(succ, start, l3, windows)
            if last:
                above[i] = (NIL if s == s0 else s, rows)
            else:
                above[i] = (s | (MARK if picked(s, l3) or s == s0 else 0), rows)
            rec["top_splitters"] += 1
        return above, s0

    lvl2 = node2.copy()
    lvl3, i0 = walk_shared(lvl2, m2, j0, False)
    lvl4, h0 = walk_shared(lvl3, lvl3.shape[0], i0, True)
    for _ in range(int(lvl4.shape[0]).bit_length()):
        nxt4 = lvl4.copy()
        for i in range(lvl4.shape[0]):
            a = lvl4[i]
            if a[0] != NIL:
                b = lvl4[a[0]]
                nxt4[i] = (b[0], (a[1] + b[1]) & 0xFFFFFFFF)
        lvl4 = nxt4
    orbit = int(lvl4[h0, 1])
    off4 = np.where(lvl4[:, 0] == NIL, orbit - lvl4[:, 1], -1)

    def offsets(below, above):
        out = np.full(below.shape[0], -1, np.int64)
        for q in range(below.shape[0]):
            x, at = int(below[q, 0]), int(below[q, 1])
            if x >> 30 == 1 and above[x & ~VISITED] >= 0:
                out[q] = above[x & ~VISITED] + at
        return out

    off2 = offsets(lvl2, offsets(lvl3, off4))
    rec["orbit"] = orbit

    # write_orbit: one thread a level-1 segment of p_0's cycle writes the
    # 4-byte words that start inside its segment: its kept bytes, a walk on
    # past them, the first bytes of the segments after it for the last word;
    # each word whole (but bytes past n); then the last CTA's fill
    rec["launches"] += 1
    out = np.full(n, -1, np.int64)
    for w in rng.permutation(m1):
        w = int(w)
        length = int(node1[w, 1])
        if length == 0 or rec1[w, 0] < 0 or off2[rec1[w, 0]] < 0:
            continue
        o = int(off2[rec1[w, 0]] + rec1[w, 1])
        acc, u = 0, 0
        nxt_slot, nxt_len, j = int(node1[w, 0]) & ~MARK, 0, 0
        for k in range(((o + 3) & ~3) - o, ((o + length + 3) & ~3) - o):
            if k < length:
                if k < kept:
                    b = int(kept_bytes[w, k])
                elif k == kept:
                    u = int(resume[w])
                    b = int(last[u])
                else:
                    word = int(sorted_keys[u])
                    u, b = word & POS_MASK, (word >> 20) & 0xFF
            else:
                nxt_len = nxt_len or int(node1[nxt_slot, 1])
                while j >= nxt_len:
                    j -= nxt_len
                    nxt_slot = int(node1[nxt_slot, 0]) & ~MARK
                    nxt_len = int(node1[nxt_slot, 1])
                b = int(kept_bytes[nxt_slot, j])
                j += 1
            pos = o + k
            acc |= b << (8 * (pos & 3))
            if pos & 3 == 3:
                for p in range(pos - 3, min(pos + 1, n)):
                    assert out[p] < 0 or p >= orbit, "two words at one place of the orbit"
                    out[p] = (acc >> (8 * (p & 3))) & 0xFF
                acc = 0
        rec["segments"] += 1
    assert (out[:orbit] >= 0).all(), "a place of the orbit left unwritten"
    out[orbit:] = out[np.arange(orbit, n) % orbit]
    return out.astype(np.uint8), rec

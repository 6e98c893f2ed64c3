"""RLE1, bzip2's first run-length pass, and the block cut.

The counterpart of ``tpubz/hostref/rle1.py``. Runs of 4..255 equal bytes
become 4 literals and a count byte; the block budget applies to the RLE1
output, and a block closes where C bzip2 closes it, so every block's content
is C's. The CRC of a block is taken over its raw input range.
``rle1_blocks`` and ``Rle1Feed`` (the routes') run the native scanner;
``rle1_encode`` with ``split_blocks``, and ``rle1_decode``, are tpubz's
numpy forms for the scalar codec.
"""
from __future__ import annotations

import threading

import numpy as np

from ..format.constants import MAX_RUN, RUN_THRESHOLD
from ..native import rle1_split_native, rle1_split_window


def _ramp(lens: np.ndarray) -> np.ndarray:
    """0..len-1 for each len, concatenated."""
    starts = np.concatenate(([0], np.cumsum(lens)))[:-1]
    return np.arange(int(lens.sum())) - np.repeat(starts, lens)


def rle1_encode(data: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RLE1 in numpy: (out, seg_out_start, seg_in_start). ``out`` is the
    uint8 RLE1 output; each run is cut greedily into segments of at most
    MAX_RUN input bytes, and the int64 output and input offsets of the
    segments' starts are the valid block cuts, each list ending with its
    length (len(out), len(data))."""
    data = np.asarray(data, dtype=np.uint8)
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
    seg_pos = _ramp(seg_cnt)  # a segment's place in its run
    is_last = seg_pos == seg_cnt[seg_run] - 1
    seg_len = np.where(is_last & (f[seg_run] > 0), f[seg_run], MAX_RUN)
    seg_in = run_starts[seg_run] + seg_pos * MAX_RUN
    lit_len = np.minimum(seg_len, RUN_THRESHOLD)
    has_cnt = seg_len >= RUN_THRESHOLD
    out_off = np.concatenate(([0], np.cumsum(lit_len + has_cnt)))
    total_out = int(out_off[-1])
    out = np.empty(total_out, dtype=np.uint8)
    lit = _ramp(lit_len)
    out[np.repeat(out_off[:-1], lit_len) + lit] = data[np.repeat(seg_in, lit_len) + lit]
    cnt_segs = np.flatnonzero(has_cnt)
    out[out_off[cnt_segs] + RUN_THRESHOLD] = (seg_len[cnt_segs] - RUN_THRESHOLD).astype(np.uint8)
    seg_out_start = np.concatenate((out_off[:-1], [total_out]))
    seg_in_start = np.concatenate((seg_in, [n]))
    return out, seg_out_start, seg_in_start


def split_blocks(out: np.ndarray, seg_out_start: np.ndarray, seg_in_start: np.ndarray,
                 budget: int) -> list[tuple[int, int, int, int]]:
    """The block cuts of ``rle1_encode``'s output by C bzip2's rule: a block
    closes at the end of the first segment that brings its output to the
    budget (up to 4 bytes over), unless fewer than two input bytes follow,
    when the tail joins it. [(out_lo, out_hi, in_lo, in_hi), ...]."""
    if int(seg_out_start[-1]) == 0:
        return []
    blocks = []
    i = 0
    nsegs = seg_out_start.size - 1
    n = int(seg_in_start[-1])
    while i < nsegs:
        lo = int(seg_out_start[i])
        # the block is segments i..m-1, the crossing one included
        m = int(np.searchsorted(seg_out_start, lo + budget, side="left"))
        if m > nsegs or int(seg_in_start[m]) > n - 2:
            m = nsegs
        blocks.append((lo, int(seg_out_start[m]), int(seg_in_start[i]), int(seg_in_start[m])))
        i = m
    return blocks


def rle1_decode(data: np.ndarray) -> np.ndarray:
    """Undo RLE1: each group of 4 equal bytes is followed by a count byte of
    further copies."""
    d = np.asarray(data, dtype=np.uint8)
    n = d.size
    if n < RUN_THRESHOLD:
        return d.copy()
    eq = d[:-1] == d[1:]
    cand = np.flatnonzero(eq[:-2] & eq[1:-1] & eq[2:])
    if cand.size == 0:
        return d.copy()
    pieces = []
    cursor = 0
    for p in cand.tolist():
        if p < cursor:
            continue
        pieces.append(d[cursor: p + 4])  # the literals up to the 4-run's end
        if p + 4 >= n:
            # a 4-run at the very end without its count: kept as it is
            cursor = p + 4
            break
        cnt = int(d[p + 4])
        if cnt:
            pieces.append(np.full(cnt, d[p], dtype=np.uint8))
        cursor = p + 5
    if cursor < n:
        pieces.append(d[cursor:])
    return np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)


def rle1_blocks(data: np.ndarray, budget: int):
    """RLE1-encode ``data`` and cut it into blocks: (rle1_out, blocks) with
    blocks = [(out_lo, out_hi, in_lo, in_hi), ...]."""
    return rle1_split_native(data, budget)


class Rle1Feed:
    """Blocks of a large input as the scan confirms them: a background
    thread scans in growing windows and re-enters at the last confirmed
    block boundary (the cuts are segment-aligned, so a re-entered scan
    gives the full scan's bytes), and the consumer iterates the blocks, so
    dispatch starts after the first window instead of the whole scan.

    ``out`` is the worst-case RLE1 output buffer; each yielded
    (out_lo, out_hi, in_lo, in_hi) indexes into it and into the input.
    ``total_estimate()`` is the exact block count once the scan is done,
    before that confirmed blocks plus the unscanned input over the budget.
    """

    # a cut decision at input position p reads bytes up to p + 5, so any
    # margin >= 8 is safe; 4096 keeps the re-scanned overlap small
    MARGIN = 4096

    def __init__(self, data: np.ndarray, budget: int, window: int = 1 << 23):
        self._arr = np.ascontiguousarray(data, dtype=np.uint8)
        n = self._arr.size
        self._budget = budget
        self._window = window
        # worst case: runs of exactly 4 expand 4 -> 5 bytes
        self.out = np.empty(n + n // 4 + 16, dtype=np.uint8)
        self._blocks: list[tuple[int, int, int, int]] = []
        self._done = False
        self._error: BaseException | None = None
        self._cv = threading.Condition()
        self._in_confirmed = 0  # input bytes covered by confirmed blocks
        self._thread = threading.Thread(target=self._scan, daemon=True)
        self._thread.start()

    def _publish(self, blocks, done):
        with self._cv:
            self._blocks.extend(blocks)
            if blocks:
                self._in_confirmed = blocks[-1][3]
            self._done = self._done or done
            self._cv.notify_all()

    def _scan(self):
        try:
            self._scan_inner()
        except BaseException as e:  # noqa: BLE001 (raised to the consumer)
            with self._cv:
                self._error = e
                self._done = True
                self._cv.notify_all()

    def _scan_inner(self):
        arr, budget = self._arr, self._budget
        n = arr.size
        start = out_base = 0
        window = max(self._window, 2 * budget)
        while True:
            end = min(n, start + window)
            blocks, _ = rle1_split_window(arr, start, end, budget, self.out, out_base)
            shifted = [(out_base + o0, out_base + o1, start + i0, start + i1)
                       for o0, o1, i0, i1 in blocks]
            if end == n:
                # the last window: every block is final
                self._publish(shifted, True)
                return
            # drop the scanner's forced tail block, then keep only blocks
            # cut safely inside the window
            safe = start + (end - start) - self.MARGIN
            keep = [b for b in shifted[:-1] if b[3] <= safe]
            if not keep:
                window *= 2  # a window smaller than one block (heavy RLE)
                continue
            self._publish(keep, False)
            out_base = keep[-1][1]
            start = keep[-1][3]

    def __iter__(self):
        i = 0
        while True:
            with self._cv:
                while i >= len(self._blocks) and not self._done:
                    self._cv.wait()
                if self._error is not None:
                    raise self._error
                if i >= len(self._blocks):
                    return
                b = self._blocks[i]
            i += 1
            yield b

    def total_estimate(self) -> int:
        with self._cv:
            nb = len(self._blocks)
            if self._done:
                return nb
            rest = self._arr.size - self._in_confirmed
        # the unscanned rest as if it did not expand: an overestimate on
        # heavy-RLE input, exact once the scan (far faster than encoding)
        # finishes
        return nb + max(1, -(-rest // self._budget))

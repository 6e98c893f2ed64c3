"""RLE1, bzip2's first run-length pass, and the block cut, on the native scanner.

The counterpart of ``tpubz/hostref/rle1.py``'s ``rle1_blocks`` and
``Rle1Feed``. Runs of 4..255 equal bytes become 4 literals and a count
byte; the block budget applies to the RLE1 output, and a block closes where
C bzip2 closes it, so every block's content is C's. The CRC of a block is
taken over its raw input range.
"""
from __future__ import annotations

import threading

import numpy as np

from ..native import rle1_split_native, rle1_split_window


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

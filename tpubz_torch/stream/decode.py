"""Whole-stream decompression, block-parallel, on the port's native decoder.

The counterpart of ``tpubz/stream/decode.py:decompress``. A bzip2 stream has
no block index and its blocks are bit-aligned, so a side thread scans every
bit offset for the 48-bit block magic and decodes each candidate on a
thread pool (the native decoder releases the GIL), while the walk in
stream order takes each block's result when it reaches it, or decodes the
block itself. A magic inside a payload costs one wasted decode that the
walk never takes. Decoding has no device leg.

``last_decode_stats`` describes the most recent stream decoded (of a
concatenation, the last): ``engine`` (always ``"native"``: this decoder runs
the native engine alone; the numpy scalar decoder, ``hostref/stream.py``,
is reached only through the command line's ``--trace-bits``), ``blocks``
and ``parallel_candidates``, the magic hits submitted to the pool (a count
that depends on the scanner thread's pace).
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..format.constants import BLOCK_MAGIC, FOOTER_MAGIC, STREAM_MAGIC
from ..format.crc import stream_crc_fold
from ..hostref.bitio import BitReader
from ..native import decode_block_native, find_magic2_native, find_magic_native

# phase attribution of the most recent stream decode (tpubz's keys)
last_decode_stats: dict = {}


def find_magic_bit_offsets(data: bytes, magic: int = BLOCK_MAGIC) -> np.ndarray:
    """Every bit offset of the 48-bit ``magic`` in ``data``, ascending
    (the native scan)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size < 6:
        return np.zeros(0, dtype=np.int64)
    return find_magic_native(arr, magic)


def split_blocks_for_parallel_decode(data: bytes) -> list[tuple[int, int]]:
    """(start_bit, end_bit) of each block magic hit past the stream header,
    the end the next hit's start or the data's end. A hit may lie inside a
    payload: a caller decodes each span and falls back to the serial walk
    (``decompress``) when a CRC or the structure fails."""
    candidates = [int(c) for c in find_magic_bit_offsets(data) if c >= 32]
    ends = candidates[1:] + [len(data) * 8]
    return list(zip(candidates, ends))


def decompress(data: bytes) -> bytes:
    """Decode .bz2 data, concatenated streams included (as bunzip2 does)."""
    out = []
    pos = 0
    while pos < len(data):
        chunk, consumed = _decompress_one(data[pos:])
        out.append(chunk)
        # streams are byte-padded; another may follow at once
        pos += consumed
        if pos >= len(data) or data[pos: pos + 3] != STREAM_MAGIC:
            break
    return b"".join(out)


def _decompress_one(data: bytes) -> tuple[bytes, int]:
    """Decode one stream, checking every block CRC and the stream CRC:
    (raw bytes, bytes consumed with the padding)."""
    br = BitReader(data)
    if bytes(br.read(8) for _ in range(3)) != STREAM_MAGIC:
        raise ValueError("not a bzip2 stream")
    level = br.read(8) - 0x30
    if not 1 <= level <= 9:
        raise ValueError("invalid block size digit")

    arr = np.frombuffer(data, dtype=np.uint8)
    futures: dict[int, object] = {}
    pool: list = [None]
    walk_pos = [32]  # shared with the scanner: blocks behind it are not submitted
    scan_err: list = [None]

    def try_decode(c):
        try:
            return decode_block_native(arr, c + 48, level)
        except ValueError:
            return None

    def scan_and_submit():
        try:
            blocks_hits, footers = find_magic2_native(arr, BLOCK_MAGIC, FOOTER_MAGIC)
            candidates = [int(c) for c in blocks_hits if c >= 32]
            # blocks past the first footer hit belong to a later stream (or
            # are payload hits): only this stream's blocks decode ahead
            if footers.size:
                candidates = [c for c in candidates if c < int(footers[0])]
            pending = [c for c in candidates if c >= walk_pos[0]]
            if len(pending) > 1:
                # 2x the cores saturates the latency-bound chase
                width = int(os.environ.get("TPUBZ_DECODE_POOL", 2 * (os.cpu_count() or 4)))
                pool[0] = ThreadPoolExecutor(min(max(width, 1), len(pending)))
                for c in pending:
                    if c >= walk_pos[0]:
                        futures[c] = pool[0].submit(try_decode, c)
        except BaseException as e:  # noqa: BLE001 (raised by the walk)
            scan_err[0] = e

    scan_thread = threading.Thread(target=scan_and_submit, daemon=True)
    scan_thread.start()
    try:
        s_crc = 0
        parts: list[np.ndarray] = []
        pos = 32  # bit position of the next block or footer magic
        while True:
            if scan_err[0] is not None:
                raise scan_err[0]
            walk_pos[0] = pos
            head = BitReader(data)
            head.pos = pos
            tag = head.read(48)
            if tag == FOOTER_MAGIC:
                stored = head.read(32)
                if stored != s_crc:
                    raise ValueError(
                        f"stream CRC mismatch: stream says {stored:#010x}, got {s_crc:#010x}")
                pos = head.pos
                break
            if tag != BLOCK_MAGIC:
                raise ValueError("invalid block header magic")
            fut = futures.get(pos)
            res = fut.result() if fut is not None else None
            if res is None:
                res = decode_block_native(arr, pos + 48, level)
            raw, end_bit, blk_crc, actual = res
            if actual != blk_crc:
                raise ValueError(
                    f"block CRC mismatch: stream says {blk_crc:#010x}, got {actual:#010x}")
            s_crc = stream_crc_fold(s_crc, blk_crc)
            parts.append(raw)
            pos = end_bit
    finally:
        walk_pos[0] = 1 << 62  # the scanner submits nothing more
        scan_thread.join()
        if pool[0] is not None:
            for f in futures.values():
                f.cancel()
            pool[0].shutdown(wait=False)
    if scan_err[0] is not None:
        raise scan_err[0]
    last_decode_stats.clear()
    last_decode_stats.update(engine="native", blocks=len(parts),
                             parallel_candidates=len(futures))
    # one copy: join over memoryviews
    return b"".join(memoryview(p) for p in parts), (pos + 7) // 8

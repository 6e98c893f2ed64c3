"""Streaming file compression and decompression in bounded memory.

The counterpart of ``tpubz/stream/files.py``. Compression: block cuts are
prefix-stable (a cut depends only on the bytes before it), so the input is
read in windows, each window keeps every complete block but the last, and
that block's raw bytes carry into the next window; one ``block_results``
pipeline of the port's scheduler spans every window. Decompression: a
sliding buffer holds only the bytes of blocks not yet decoded, and the
block magics found in it decode ahead on a thread pool.
"""
from __future__ import annotations

import io
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..block.encode import resolve_device
from ..format.constants import BLOCK_MAGIC, FOOTER_MAGIC, STREAM_MAGIC, block_budget
from ..format.crc import stream_crc_fold
from ..hostref.bitio import BitAccum, BitReader, splice_byte_chunks
from ..hostref.rle1 import rle1_blocks
from ..native import decode_block_native, find_magic_native
from .api import block_results

WINDOW_BYTES = int(os.environ.get("TPUBZ_STREAM_WINDOW", str(32 * 1024 * 1024)))


class _BitSink:
    """MSB-first bit writer onto a byte stream."""

    def __init__(self, fout):
        self.fout = fout
        self._rem_val = 0  # pending bits (< 8)
        self._rem_bits = 0
        self.total_bits = 0

    def write_fields(self, vals: np.ndarray, bits: np.ndarray) -> None:
        acc = BitAccum()
        acc.extend(np.asarray(vals, np.uint32), np.asarray(bits, np.int64))
        self.write_chunk(*acc.pack())

    def write_chunk(self, data: bytes, nbits: int) -> None:
        """Write a byte-padded bit chunk (zero pad bits), carrying the
        sub-byte remainder from call to call."""
        pieces = []
        if self._rem_bits:
            pieces.append((bytes([(self._rem_val << (8 - self._rem_bits)) & 0xFF]),
                           self._rem_bits))
        pieces.append((data, nbits))
        payload, total = splice_byte_chunks(pieces)
        self.total_bits += nbits
        full = total // 8
        rem = total - full * 8
        arr = np.frombuffer(payload, np.uint8)
        self.fout.write(arr[:full].tobytes())
        self._rem_val = (int(arr[full]) >> (8 - rem)) if rem else 0
        self._rem_bits = rem

    def close(self) -> None:
        if self._rem_bits:
            self.fout.write(bytes([(self._rem_val << (8 - self._rem_bits)) & 0xFF]))
            self._rem_bits = 0


class _WindowItems:
    """(RLE1 block, raw input range) items over a file read in windows, for
    one pipeline across the whole file. A producer thread reads and scans
    the next window while the pipeline encodes this one (one window of
    lookahead). The views pin at most the windows that hold the blocks in
    flight."""

    def __init__(self, fin, budget: int, first_data: np.ndarray | None = None):
        self._fin = fin
        self._budget = budget
        self._first = first_data
        self._emitted = 0
        self._raw_seen = 0  # raw bytes covered by emitted blocks
        self._done = False
        try:
            rest = os.fstat(fin.fileno()).st_size - fin.tell()
            self._size_hint = max(0, rest) + (first_data.size if first_data is not None else 0)
        except (OSError, AttributeError, ValueError, io.UnsupportedOperation):
            self._size_hint = None

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=1)
        stop = [False]

        def produce():
            try:
                budget = self._budget
                carry = np.zeros(0, np.uint8)
                pending = self._first
                self._first = None
                eof = False
                while (not eof or carry.size) and not stop[0]:
                    if pending is not None:
                        data, pending = pending, None
                        if data.size == 0:
                            eof = True
                            continue
                    else:
                        chunk = self._fin.read(WINDOW_BYTES) if not eof else b""
                        if not chunk:
                            eof = True
                        data = (np.concatenate((carry, np.frombuffer(chunk, np.uint8)))
                                if chunk else carry)
                        if data.size == 0:
                            break
                    out, blocks = rle1_blocks(data, budget)
                    if not eof and len(blocks) > 1:
                        keep = blocks[:-1]
                        carry = data[blocks[-1][2]:].copy()
                    elif not eof:
                        carry = data  # fewer than 2 blocks: read more first
                        continue
                    else:
                        keep = blocks
                        carry = np.zeros(0, np.uint8)
                    while not stop[0]:
                        try:
                            q.put((out, data, keep), timeout=0.2)
                            break
                        except queue.Full:
                            pass
                q.put(None)
            except BaseException as e:  # noqa: BLE001 (raised to the consumer)
                q.put(e)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                out, data, keep = item
                for o0, o1, i0, i1 in keep:
                    self._emitted += 1
                    self._raw_seen += i1 - i0
                    yield out[o0:o1], data[i0:i1]
            self._done = True
        finally:
            # a consumer that stops early unblocks the producer
            stop[0] = True
            try:
                q.get_nowait()
            except queue.Empty:
                pass

    def total_estimate(self) -> int:
        if self._done:
            return max(self._emitted, 1)
        if self._size_hint is None:
            # a pipe: the length is unknown, so claim a healthy remainder
            # and keep the device eligible mid-stream
            return self._emitted + 8
        rest = max(0, self._size_hint - self._raw_seen)
        return self._emitted + max(1, -(-rest // self._budget))


def compress_stream(fin, fout, level: int = 9, *, device="cuda") -> int:
    """Compress the binary stream ``fin`` into a .bz2 stream on ``fout``
    with device blocks on ``device`` (None: the CPU engine alone). Returns
    the bytes written."""
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    dev = None if device is None else resolve_device(device)
    sink = _BitSink(fout)
    header = BitAccum()
    for b in STREAM_MAGIC:
        header.put(b, 8)
    header.put(0x30 + level, 8)
    sink.write_fields(*header.arrays())

    budget = block_budget(level)
    # the engine choice needs a block count before the pipeline starts: a
    # stream that ends inside the first window counts its blocks there; a
    # longer one goes by the reader's estimate, a window's worth or more
    first = np.frombuffer(fin.read(WINDOW_BYTES), np.uint8)
    items = _WindowItems(fin, budget, first_data=first)
    n_blocks = None
    if first.size < WINDOW_BYTES:
        n_blocks = len(rle1_blocks(first, budget)[1])
    s_crc = 0
    for crc, blk_bytes, nbits in block_results(level, items, dev, n_blocks):
        s_crc = stream_crc_fold(s_crc, crc)
        sink.write_chunk(blk_bytes, nbits)
    footer = BitAccum()
    footer.put(FOOTER_MAGIC, 48)
    footer.put(s_crc, 32)
    sink.write_fields(*footer.arrays())
    sink.close()
    return (sink.total_bits + 7) // 8


def compress_file(src: str, dst: str, level: int = 9, *, device="cuda") -> None:
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        compress_stream(fin, fout, level, device=device)


def decompress_stream(fin, fout) -> int:
    """Decompress a .bz2 stream, concatenated streams included, in bounded
    memory: the buffer holds about two windows of bytes not yet decoded (a
    block's compressed span is far below a window). Returns the bytes
    written."""
    window = max(WINDOW_BYTES, 64 * 1024)
    buf = b""
    eof = False
    pos = 0  # bit position in buf
    total = 0
    level = None
    s_crc = 0
    in_stream = False
    # block magics found in the buffered bytes decode ahead on a pool; a
    # re-base shifts the offsets, and each entry keeps the bit shift to
    # apply to its end_bit (its decode holds its own buffer snapshot)
    pool: ThreadPoolExecutor | None = None
    predec: dict[int, list] = {}  # bit offset -> [future, bit shift]
    scanned = 0
    try:
        while True:
            while not eof and len(buf) - pos // 8 < 2 * window:
                chunk = fin.read(window)
                if not chunk:
                    eof = True
                    break
                buf += chunk
            # drop the decoded whole bytes once a window's worth has built up
            drop = pos // 8
            if drop >= window:
                buf = buf[drop:]
                pos -= drop * 8
                shifted: dict[int, list] = {}
                for k, (f, sh) in predec.items():
                    if k - drop * 8 >= pos:
                        shifted[k - drop * 8] = [f, sh + drop * 8]
                    else:
                        f.cancel()
                predec = shifted
                scanned = max(scanned - drop, 0)
            if in_stream and len(buf) > scanned:
                arr_scan = np.frombuffer(buf, np.uint8)
                lo = max(scanned - 7, 0)
                hits = find_magic_native(arr_scan[lo:], BLOCK_MAGIC)
                if pool is None:
                    pool = ThreadPoolExecutor(4)

                def _try(b0, a=arr_scan, lv=level):
                    try:
                        return decode_block_native(a, b0 + 48, lv)
                    except ValueError:
                        return None

                for h in hits:
                    b0 = int(h) + lo * 8
                    if b0 >= pos and b0 not in predec:
                        predec[b0] = [pool.submit(_try, b0), 0]
                scanned = len(buf)
            if not in_stream:
                if pos // 8 >= len(buf):
                    break  # a clean end between streams
                if total and buf[pos // 8: pos // 8 + 3] != STREAM_MAGIC:
                    break  # bytes after the last stream are ignored
                if len(buf) * 8 - pos < 32:
                    raise ValueError("truncated stream header")
                hdr = BitReader(buf)
                hdr.pos = pos
                if bytes(hdr.read(8) for _ in range(3)) != STREAM_MAGIC:
                    raise ValueError("not a bzip2 stream")
                level = hdr.read(8) - 0x30
                if not 1 <= level <= 9:
                    raise ValueError("invalid block size digit")
                pos = hdr.pos
                s_crc = 0
                in_stream = True
                continue
            if len(buf) * 8 - pos < 48:
                raise ValueError("truncated stream")
            br = BitReader(buf)
            br.pos = pos
            tag = br.read(48)
            if tag == FOOTER_MAGIC:
                if br.read(32) != s_crc:
                    raise ValueError("stream CRC mismatch")
                pos = (br.pos + 7) // 8 * 8  # byte-aligned; another stream may follow
                in_stream = False
                if eof and pos // 8 >= len(buf):
                    break
                continue
            if tag != BLOCK_MAGIC:
                raise ValueError("invalid block header magic")
            entry = predec.pop(pos, None)
            res = entry[0].result() if entry is not None else None
            try:
                if res is not None:
                    raw, end_bit, blk_crc, actual = res
                    end_bit -= entry[1]
                else:
                    raw, end_bit, blk_crc, actual = decode_block_native(
                        np.frombuffer(buf, np.uint8), pos + 48, level)
            except ValueError:
                # the block may run past the buffered bytes, or be corrupt:
                # read more only while the buffered span could still be
                # shorter than the largest compressed block (3x the 900k
                # budget bounds it); past that, raise instead of reading
                # the rest of the input
                max_block_bytes = level * 100_000 * 3 + 4096
                if not eof and len(buf) - pos // 8 < max_block_bytes:
                    chunk = fin.read(window)
                    if chunk:
                        buf += chunk
                        continue
                    eof = True
                raise
            if actual != blk_crc:
                raise ValueError("block CRC mismatch")
            s_crc = stream_crc_fold(s_crc, blk_crc)
            fout.write(raw.tobytes())
            total += raw.size
            pos = end_bit
    finally:
        if pool is not None:
            for f, _ in predec.values():
                f.cancel()
            pool.shutdown(wait=False)
    return total


def decompress_file(src: str, dst: str) -> None:
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        decompress_stream(fin, fout)

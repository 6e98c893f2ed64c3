"""Incremental codec objects, drop-ins for ``bz2.BZ2Compressor`` and
``bz2.BZ2Decompressor``.

The counterpart of ``tpubz/incremental.py``. ``BZ2Compressor`` runs the
port's ``compress_stream`` on a worker thread fed through the bounded chunk
queue of ``fileobj.py``, with the blocks on ``device``; a worker's error is
raised by the next ``compress`` or by ``flush``.

``BZ2Decompressor`` parses one stream from a growing buffer: the header,
then each block through the native decoder, then the footer, which sets
``eof`` and ``unused_data``. A block decode that fails while the buffered
tail is still shorter than the largest compressed block means "more input";
past that bound the block is corrupt. The block magics in buffered bytes
decode ahead on a small thread pool, so a large stream fed in chunks decodes
at the parallel rate.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .fileobj import _Bridge, _BridgeReader
from .format.constants import BLOCK_MAGIC, FOOTER_MAGIC, STREAM_MAGIC
from .format.crc import stream_crc_fold
from .hostref.bitio import BitReader
from .native import decode_block_native, find_magic_native


class BZ2Compressor:
    """Incremental compressor whose blocks run on ``device`` ("cuda" or
    "cpu")."""

    def __init__(self, compresslevel: int = 9, *, device="cuda"):
        if not 1 <= compresslevel <= 9:
            raise ValueError("compresslevel must be between 1 and 9")
        from .block.encode import resolve_device

        resolve_device(device)  # "cuda" without a card raises here
        self._bridge = _Bridge()
        self._out: list[bytes] = []
        self._out_lock = threading.Lock()
        self._err: BaseException | None = None
        self._flushed = False
        outer = self

        class _Sink:
            def write(self, data) -> int:
                b = bytes(data)
                with outer._out_lock:
                    outer._out.append(b)
                return len(b)

        def work():
            from .stream.files import compress_stream

            try:
                compress_stream(_BridgeReader(self._bridge), _Sink(), compresslevel,
                                device=device)
            except BaseException as e:  # noqa: BLE001 (raised on the caller's side)
                self._err = e
                self._bridge.dead = True

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

    def _drain(self) -> bytes:
        with self._out_lock:
            chunks, self._out = self._out, []
        return b"".join(chunks)

    def compress(self, data) -> bytes:
        """Feed ``data``; returns the compressed bytes ready so far (often
        ``b""``: output comes a block at a time)."""
        if self._flushed:
            raise ValueError("Compressor has been flushed")
        if self._err is not None:
            raise self._err
        b = bytes(data)
        if b:
            self._bridge.put(b)
        return self._drain()

    def flush(self) -> bytes:
        """Finish the stream; returns the rest of the compressed bytes."""
        if self._flushed:
            raise ValueError("Repeated call to flush()")
        self._flushed = True
        self._bridge.close_write()
        self._worker.join()
        if self._err is not None:
            raise self._err
        return self._drain()


class BZ2Decompressor:
    """Incremental single-stream decompressor, a drop-in for
    ``bz2.BZ2Decompressor`` (concatenated input takes a new decompressor
    per stream, as with the stdlib)."""

    def __init__(self):
        self._buf = b""
        self._pos = 0  # bit position in _buf
        self._level: int | None = None
        self._s_crc = 0
        self._pending = bytearray()  # decoded, not yet returned
        # the footer was parsed; eof shows only once the pending output has
        # drained (the stdlib's contract)
        self._done = False
        self.eof = False
        self.unused_data = b""
        self.needs_input = True
        # decodes ahead: bit offset -> [future, bit shift from re-bases,
        # buffer length the decode saw]
        self._pool = None
        self._predec: dict[int, list] = {}
        self._scanned = 0  # bytes scanned for block magics

    def _shutdown_pool(self) -> None:
        if self._pool is not None:
            for ent in self._predec.values():
                ent[0].cancel()
            self._pool.shutdown(wait=False)
            self._pool = None
        self._predec = {}

    def __del__(self):
        try:
            self._shutdown_pool()
        except Exception:  # noqa: BLE001 (interpreter shutdown)
            pass

    def _scan_predecode(self) -> None:
        """Scan the newly buffered bytes for block magics and decode the
        candidates ahead. A candidate's first decode may have seen its block
        cut short (chunks smaller than a block are the normal case), so a
        failed one is submitted again on the grown buffer once its block is
        plausibly whole: a later magic is buffered behind it, or, for the
        last block, the buffer grew 256 KiB past that decode's."""
        if self._level is None or len(self._buf) <= self._scanned:
            return
        arr = np.frombuffer(self._buf, np.uint8)
        cur_len = len(self._buf)
        lo = max(self._scanned - 7, 0)
        hits = find_magic_native(arr[lo:], BLOCK_MAGIC)
        self._scanned = cur_len
        if not len(hits) and not self._predec:
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(int(os.environ.get("TPUBZ_DECODE_THREADS", "4")))
        lvl = self._level

        def _try(b0, a=arr, lv=lvl):
            try:
                return decode_block_native(a, b0 + 48, lv)
            except ValueError:
                return None

        for h in hits:
            b0 = int(h) + lo * 8
            if b0 >= self._pos and b0 not in self._predec:
                self._predec[b0] = [self._pool.submit(_try, b0), 0, cur_len]
        max_b0 = max(self._predec, default=-1)
        for b0, ent in self._predec.items():
            fut, _, snap = ent
            if (snap < cur_len and fut.done() and fut.result() is None
                    and (b0 < max_b0 or cur_len - snap >= 1 << 18)):
                # offsets are relative to the current buffer, so the
                # re-base shift starts again from 0
                ent[0] = self._pool.submit(_try, b0)
                ent[1] = 0
                ent[2] = cur_len

    def _parse_header(self) -> bool:
        if len(self._buf) < 4:
            return False
        if self._buf[:3] != STREAM_MAGIC:
            raise ValueError("Invalid data stream")
        level = self._buf[3] - 0x30
        if not 1 <= level <= 9:
            raise ValueError("Invalid data stream")
        self._level = level
        self._pos = 32
        return True

    def _step(self) -> bool:
        """Decode one block or the footer; False when more input is needed."""
        if len(self._buf) * 8 - self._pos < 48 + 32:
            return False  # the shortest item left is the footer magic and CRC
        br = BitReader(self._buf)
        br.pos = self._pos
        tag = br.read(48)
        if tag == FOOTER_MAGIC:
            if br.read(32) != self._s_crc:
                raise ValueError("stream CRC mismatch")
            self._done = True
            self.unused_data = self._buf[(br.pos + 7) // 8:]
            self._buf = b""
            self._shutdown_pool()
            return False
        if tag != BLOCK_MAGIC:
            raise ValueError("invalid block header magic")
        entry = self._predec.pop(self._pos, None)
        pre = entry[0].result() if entry is not None else None
        try:
            if pre is not None:
                raw, end_bit, blk_crc, actual = pre
                end_bit -= entry[1]
            else:
                raw, end_bit, blk_crc, actual = decode_block_native(
                    np.frombuffer(self._buf, np.uint8), self._pos + 48, self._level)
        except ValueError:
            # the block may run past the buffered bytes, or be corrupt; a
            # valid compressed block never spans more than 3x the 900k
            # budget, so within that bound ask for more input
            max_block_bytes = self._level * 100_000 * 3 + 4096
            if len(self._buf) - self._pos // 8 < max_block_bytes:
                return False
            raise
        if actual != blk_crc:
            raise ValueError("block CRC mismatch")
        self._s_crc = stream_crc_fold(self._s_crc, blk_crc)
        self._pending += raw.tobytes()
        self._pos = end_bit
        # re-base: drop the consumed whole bytes so memory follows the
        # unparsed tail; the decodes ahead shift with it
        drop = self._pos // 8
        if drop >= 1 << 20:
            self._buf = self._buf[drop:]
            self._pos -= drop * 8
            shifted: dict[int, list] = {}
            for k, (f, sh, snap) in self._predec.items():
                if k - drop * 8 >= self._pos:
                    shifted[k - drop * 8] = [f, sh + drop * 8, max(snap - drop, 0)]
                else:
                    f.cancel()
            self._predec = shifted
            self._scanned = max(self._scanned - drop, 0)
        return True

    def decompress(self, data, max_length: int = -1) -> bytes:
        if self.eof:
            raise EOFError("End of stream already reached")
        if data:
            self._buf += bytes(data)
        try:
            if self._level is None and self._buf:
                self._parse_header()
            if self._level is not None:
                self._scan_predecode()
                while not self._done and self._step():
                    pass
        except Exception:
            self.needs_input = False
            self._shutdown_pool()
            raise
        if max_length >= 0 and len(self._pending) > max_length:
            out = bytes(self._pending[:max_length])
            del self._pending[:max_length]
        else:
            out, self._pending = bytes(self._pending), bytearray()
        # the stdlib's contract: eof once the stream ended and its output
        # drained; needs_input False while output is buffered or at the end
        self.eof = self._done and not self._pending
        self.needs_input = not self._pending and not self._done
        return out

"""File-object API: ``tpubz_torch.open()``, a drop-in for ``bz2.open``.

The counterpart of ``tpubz/fileobj.py``, on the port's streaming codecs
(``stream/files.py``). The codecs read their input (compression) and write
their output (decompression), so each direction runs on a worker thread
joined to the caller by a small bounded chunk queue: backpressure both
ways, and the worker's errors are raised on the caller's side. Writing runs
the blocks on ``device``; a worker's error, a device error included, is
raised by the next ``write`` or by ``close``. Reading is host-only.
"""
from __future__ import annotations

import io
import queue
import threading


class _Bridge:
    """Bounded byte-chunk pipe between a caller and a codec worker."""

    _EOF = object()

    def __init__(self, maxsize: int = 8):
        self.q: queue.Queue = queue.Queue(maxsize)
        self.dead = False  # the consumer is gone: writers drop, not block

    def put(self, data) -> None:
        while not self.dead:
            try:
                self.q.put(data, timeout=0.1)
                return
            except queue.Full:
                continue

    def close_write(self) -> None:
        self.put(self._EOF)

    def get(self):
        return self.q.get()


class _BridgeReader(io.RawIOBase):
    """Blocking reader over a _Bridge (a codec worker's input)."""

    def __init__(self, bridge: _Bridge):
        self._b = bridge
        self._buf = b""
        self._eof = False

    def readable(self) -> bool:
        return True

    def _fill(self, n: int) -> None:
        while not self._eof and (n < 0 or len(self._buf) < n):
            chunk = self._b.get()
            if chunk is _Bridge._EOF:
                self._eof = True
                break
            self._buf += chunk

    def read(self, n: int = -1) -> bytes:
        self._fill(n)
        if n < 0 or n >= len(self._buf):
            out, self._buf = self._buf, b""
        else:
            out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def peek(self, n: int = 1) -> bytes:
        self._fill(max(n, 1))
        return self._buf


class _BridgeWriter(io.RawIOBase):
    """Blocking writer over a _Bridge (a decode worker's output)."""

    def __init__(self, bridge: _Bridge):
        self._b = bridge

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        if data:
            self._b.put(bytes(data))
        return len(data)


class _Aborted(Exception):
    """Raised inside a decode worker whose file rewound or closed."""


class _AbortableSource(io.RawIOBase):
    """Read-through wrapper that lets the owner stop a decode worker at its
    next read, so ``seek``'s rewind retires the worker without decoding the
    rest of the file or racing it for the file position."""

    def __init__(self, fp, abort: threading.Event):
        self._fp = fp
        self._abort = abort

    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        if self._abort.is_set():
            raise _Aborted
        return self._fp.read(n)


class TpubzFile(io.BufferedIOBase):
    """``bz2.BZ2File``-compatible file object over .bz2 data (binary
    modes); writing runs its blocks on ``device`` ("cuda" or "cpu")."""

    def __init__(self, filename, mode: str = "rb", compresslevel: int = 9, *,
                 device="cuda"):
        if not 1 <= compresslevel <= 9:
            raise ValueError("compresslevel must be 1..9")
        m = mode.replace("b", "")
        if m not in ("r", "w", "x", "a"):
            raise ValueError(f"invalid mode: {mode!r}")
        self._writing = m != "r"
        if self._writing:
            # resolved before a file is opened: "cuda" without a card raises
            from .block.encode import resolve_device

            resolve_device(device)
        if hasattr(filename, "read") or hasattr(filename, "write"):
            self._fp = filename
            self._owns_fp = False
        else:
            # append starts a new stream: concatenated streams are valid bzip2
            self._fp = io.open(filename, m + "b")
            self._owns_fp = True
        self._bridge = _Bridge()
        self._exc: list[BaseException] = []
        self._closed = False
        self._pos = 0
        if self._writing:
            target = self._fp

            def work():
                from .stream.files import compress_stream

                try:
                    compress_stream(_BridgeReader(self._bridge), target, compresslevel,
                                    device=device)
                except BaseException as e:  # noqa: BLE001 (raised on write or close)
                    self._exc.append(e)
                    self._bridge.dead = True

            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()
        else:
            self._start_read_worker()

    def _start_read_worker(self) -> None:
        """(Re)start the decode worker at the current file position."""
        self._bridge = _Bridge()
        self._abort = threading.Event()
        src = _AbortableSource(self._fp, self._abort)
        bridge = self._bridge

        def work():
            from .stream.files import decompress_stream

            try:
                decompress_stream(src, _BridgeWriter(bridge))
            except _Aborted:
                pass  # the owner rewound or closed; the output is discarded
            except BaseException as e:  # noqa: BLE001 (raised on read)
                self._exc.append(e)
            finally:
                bridge.close_write()

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()
        self._reader = _BridgeReader(self._bridge)

    def _retire_read_worker(self) -> None:
        """Stop the decode worker and wait for it to exit."""
        self._abort.set()
        self._bridge.dead = True  # unblock a worker in put
        try:
            while True:
                self._bridge.q.get_nowait()
        except queue.Empty:
            pass
        self._worker.join()

    def _check(self, writing: bool | None = None) -> None:
        if self._closed:
            raise ValueError("I/O operation on closed file")
        if writing is True and not self._writing:
            raise io.UnsupportedOperation("file not open for writing")
        if writing is False and self._writing:
            raise io.UnsupportedOperation("file not open for reading")
        if self._exc:
            raise self._exc[0]

    def readable(self) -> bool:
        return not self._writing

    def read(self, n: int = -1) -> bytes:
        self._check(writing=False)
        out = self._reader.read(n)
        self._check(writing=False)  # a decode error surfaces at once
        self._pos += len(out)
        return out

    def read1(self, n: int = -1) -> bytes:
        return self.read(n if n >= 0 else io.DEFAULT_BUFFER_SIZE)

    def peek(self, n: int = 1) -> bytes:
        """Buffered decompressed bytes without moving the position (at
        least one byte unless at the end; may return more than ``n``, as
        ``bz2.BZ2File.peek`` does)."""
        self._check(writing=False)
        out = self._reader.peek(n)
        self._check(writing=False)
        return out

    def writable(self) -> bool:
        return self._writing

    def write(self, data) -> int:
        self._check(writing=True)
        data = bytes(data)
        step = 1 << 20
        for off in range(0, len(data), step):
            self._bridge.put(data[off: off + step])
            self._check(writing=True)
        self._pos += len(data)
        return len(data)

    def tell(self) -> int:
        self._check()
        return self._pos

    def seekable(self) -> bool:
        return (not self._closed and not self._writing
                and getattr(self._fp, "seekable", lambda: False)())

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        """Seek in the decompressed stream (read modes), as
        ``bz2.BZ2File.seek`` does: a backward seek rewinds the file and
        decodes again; ``SEEK_END`` decodes to the end first."""
        self._check(writing=False)
        if not self.seekable():
            raise io.UnsupportedOperation("seek")
        if whence == io.SEEK_SET:
            target = offset
        elif whence == io.SEEK_CUR:
            target = self._pos + offset
        elif whence == io.SEEK_END:
            while self.read(1 << 20):
                pass
            target = self._pos + offset
        else:
            raise ValueError(f"invalid whence: {whence!r}")
        target = max(target, 0)
        if target < self._pos:
            self._retire_read_worker()
            self._fp.seek(0)
            self._exc.clear()
            self._start_read_worker()
            self._pos = 0
        while self._pos < target:
            if not self.read(min(1 << 20, target - self._pos)):
                break  # past the end: park at the end, as bz2 does
        return self._pos

    def fileno(self) -> int:
        self._check()
        return self._fp.fileno()

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if self._closed:
            return
        try:
            if self._writing:
                self._bridge.close_write()
                self._worker.join()
            else:
                self._retire_read_worker()
            if self._exc:
                raise self._exc[0]
        finally:
            self._closed = True
            if self._owns_fp:
                self._fp.close()


def open(filename, mode: str = "rb", compresslevel: int = 9,  # noqa: A001 (mirrors bz2.open)
         encoding=None, errors=None, newline=None, *, device="cuda"):
    """Open a bzip2-compressed file, a drop-in for ``bz2.open``. Binary
    modes return a :class:`TpubzFile`; text modes wrap it in
    :class:`io.TextIOWrapper`."""
    if "t" in mode:
        if "b" in mode:
            raise ValueError(f"invalid mode: {mode!r}")
        binary = TpubzFile(filename, mode.replace("t", ""), compresslevel, device=device)
        return io.TextIOWrapper(binary, encoding, errors, newline)
    if encoding is not None or errors is not None or newline is not None:
        raise ValueError("encoding args invalid for binary mode")
    return TpubzFile(filename, mode, compresslevel, device=device)

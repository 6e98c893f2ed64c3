"""File-object API: ``tpubz_torch.open()``, a drop-in for ``bz2.open``.

The counterpart of ``tpubz/fileobj.py``. The read side, the seek emulation
and the bounded chunk bridges are tpubz's (``TpubzFile`` is subclassed);
only the write worker differs: it runs the port's ``compress_stream`` with
the blocks on ``device``. A worker's error, a device error included, is
raised by the next ``write`` or by ``close``.
"""
from __future__ import annotations

import io
import threading

from tpubz import fileobj as _tfileobj
from tpubz.fileobj import _Bridge, _BridgeReader


class TpubzFile(_tfileobj.TpubzFile):
    """``bz2.BZ2File``-compatible file object over .bz2 data; writing runs
    its blocks on ``device`` ("cuda" or "cpu")."""

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
                except BaseException as e:  # noqa: BLE001 (re-raised on write or close)
                    self._exc.append(e)
                    self._bridge.dead = True

            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()
        else:
            self._start_read_worker()


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

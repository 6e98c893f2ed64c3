"""Incremental codec objects, drop-ins for ``bz2.BZ2Compressor`` and
``bz2.BZ2Decompressor``.

The counterpart of ``tpubz/incremental.py``. ``BZ2Compressor`` is tpubz's
(subclassed) with its worker on the port's ``compress_stream``, the blocks on
``device``; a worker's error is raised by the next ``compress`` or by
``flush``. ``BZ2Decompressor`` is tpubz's: decoding has no device leg.
"""
from __future__ import annotations

import threading

from tpubz import incremental as _tincremental
from tpubz.fileobj import _Bridge, _BridgeReader
from tpubz.incremental import BZ2Decompressor  # noqa: F401 (re-exported)


class BZ2Compressor(_tincremental.BZ2Compressor):
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
            except BaseException as e:  # noqa: BLE001 (re-raised on the caller's side)
                self._err = e
                self._bridge.dead = True

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

"""Spans of the port's own layers, recorded in memory while a recording is on.

Off by default. While off, ``span()`` makes one check of a module global and
returns the shared no-op span: it reads no clock, takes no lock and
allocates nothing. While on (``recording()``, or ``start()`` and
``stop()``), every thread of the process records its spans into the one
recorder until it is stopped. There is no exporter and no environment variable: the spans stay
in memory, on the recorder that ``stop()`` returns.

A span record (``Span``):
  name            what ran (the port's names below)
  start_ns/end_ns ``time.perf_counter_ns()`` at its start and end
  cpu_ns          ``time.thread_time_ns()`` of its thread over the span
  thread          ``threading.get_ident()`` of its thread
  stream          the ``compress`` call it belongs to (``new_stream()``; one
                  id a call, on every thread of the call; 0 for work that no
                  call opened)
  block           the block's index in its stream, -1 for a stream's own spans
  parent          the id of the span open around it on the same thread, or None
  id, attrs       its own id and what its site attached

The port's spans (``stream/api.py``, ``block/encode.py``):
  stream          a ``compress`` call, entry to return; attrs bytes, blocks, stage
  stream.setup    entry to the first request for a block (the device, the RLE1
                  feed's start, the settings, the routing profile, the pools)
  stream.fill     each request for the next block (the wait on the RLE1 feed)
  stream.finish   the caller's request after the last block to return (the
                  profile's update, the pools' shutdown, the footer)
  dispatch        the dispatcher's work on a block; attr n, its bytes. Its self
                  time is the BWT library call and the MTF and RLE2 enqueues
  dispatch.upload ``DeviceBlockEncoder.upload``
  dispatch.copies ``fetch_async`` / ``fetch_bwt_async``: the host copies' enqueue
  fetch.wait      a fetch thread's wait on a block's copies and its BWT call's
                  finish; attr bwt_device_ns, the call's time on the card
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

_on = False  # the one check an idle span site makes
_recorder = None
_ids = itertools.count(1)
_streams = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()  # start() and stop() only


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """A recorded span: live between ``start()`` (or ``with``) and
    ``end()``, a record after. ``stream`` and ``block`` left as None take
    the open parent's on the same thread."""

    __slots__ = ("name", "stream", "block", "attrs", "id", "parent", "thread", "start_ns",
                 "end_ns", "cpu_ns", "_rec", "_at")

    def __init__(self, name, stream, block, at):
        self.name = name
        self.stream = stream
        self.block = block
        self.attrs = {}
        self.id = next(_ids)
        self.parent = self.thread = self.start_ns = self.end_ns = self.cpu_ns = None
        self._rec = _recorder
        self._at = at

    def start(self) -> Span:
        st = _stack()
        up = st[-1] if st else None
        self.parent = None if up is None else up.id
        if self.stream is None:
            self.stream = 0 if up is None else up.stream
        if self.block is None:
            self.block = -1 if up is None else up.block
        self.thread = threading.get_ident()
        st.append(self)
        if self._at is not None:
            self.start_ns, self.cpu_ns = self._at
        else:  # the thread's CPU interval inside the wall interval
            self.start_ns = time.perf_counter_ns()
            self.cpu_ns = time.thread_time_ns()
        return self

    def end(self) -> None:
        """Close the span (once; later calls do nothing) and keep it on the
        recorder it was opened under, unless that recorder has stopped."""
        if self.end_ns is not None or self.start_ns is None:
            return
        self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        self.end_ns = time.perf_counter_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        if self._rec is _recorder and self._rec is not None:
            self._rec.spans.append(self)  # list.append holds under the GIL

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> Span:
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end()
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, stream={self.stream}, block={self.block}, "
                f"start_ns={self.start_ns}, end_ns={self.end_ns}, attrs={self.attrs})")


class _Off:
    """The span of every site while nothing records: it does nothing and is
    false, so a site can skip work that only a recorded span needs."""

    __slots__ = ()

    def start(self):
        return self

    def end(self):
        pass

    def set(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __bool__(self):
        return False


_OFF = _Off()


def span(name: str, *, stream: int | None = None, block: int | None = None, at=None):
    """A span named ``name``, to use in a ``with`` statement (or to
    ``start()`` and ``end()``); ``at``, a ``now()`` reading, starts it at
    that time. While nothing records: the shared no-op span, which is
    false, so that a site computes what it attaches (``set``) only for a
    recorded span. The signature takes no ``**attrs``: Python would build
    their dict on every call, recorded or not."""
    if not _on:
        return _OFF
    return Span(name, stream, block, at)


def now():
    """(perf_counter_ns, thread_time_ns) now while recording, else None:
    the ``at`` of a span that starts before its site knows it will open."""
    if not _on:
        return None
    return time.perf_counter_ns(), time.thread_time_ns()


def new_stream() -> int:
    """A fresh stream id while recording, else 0."""
    return next(_streams) if _on else 0


def current_stream() -> int:
    """The stream of the innermost span open on this thread, or 0."""
    if not _on:
        return 0
    st = _stack()
    return st[-1].stream if st else 0


def annotate(name: str, **attrs) -> None:
    """Attach ``attrs`` to the innermost span named ``name`` open on this
    thread, if any (and only while recording)."""
    if not _on:
        return
    for s in reversed(_stack()):
        if s.name == name:
            s.attrs.update(attrs)
            return


class Recorder:
    """What one recording kept: ``spans``, in the order they ended."""

    def __init__(self):
        self.spans: list[Span] = []


def start() -> Recorder:
    """Turn recording on for every thread of the process."""
    global _on, _recorder
    with _lock:
        if _recorder is not None:
            raise RuntimeError("a span recording is already on")
        _recorder = Recorder()
        _on = True
        return _recorder


def stop() -> Recorder | None:
    """Turn recording off; the recorder's spans are final (a span that ends
    later is not kept). None if nothing was recording."""
    global _on, _recorder
    with _lock:
        rec, _recorder = _recorder, None
        _on = False
        return rec


@contextlib.contextmanager
def recording():
    """Record spans inside the ``with``; yields the recorder."""
    rec = start()
    try:
        yield rec
    finally:
        stop()

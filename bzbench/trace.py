"""The traced run's instruments: spans wrapped around the program's layers
from the benchmark's side, and the device timeline of ``torch.profiler``.

``Probe.install`` wraps, for the length of a run:
- the stream's record of its device blocks, ``last_stream_events``
  (``blocks``);
- the dispatcher's calls ``DeviceBlockEncoder.transform`` /
  ``transform_bwt`` and ``fetch_async`` / ``fetch_bwt_async`` (span
  ``dispatch``), the emission ``emit_block`` (``emit``, with each block's
  RLE2 length) and the bwt stage's host MTF/RLE2 ``mtf_rle2_native``
  (``host_mtf_rle2``): host clock, every call;
- the BWT call ``bwt_forward_async`` as ``block/encode.py`` calls it
  (``bwt``, with each block's length n).
``uninstall`` puts every name back. Nothing of the program is edited.

``Timeline`` reads a ``torch.profiler`` session: the kernel, copy and set
intervals on the card, and each BWT call's span from its ``bwt_setup``
kernel to its ``bwt_last_column`` kernel, the launches outside its graph
(the profiler may trace only part of a graph's loop; on one stream nothing
else runs between them). The host's spans are put on the profiler's clock
by annotations that the thread running the session records on both.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch


class _StreamEvents(list):
    """``stream.api.last_stream_events`` while a probe is in: the device
    blocks' (dispatched, emitted) times go to the probe, and a new stream's
    ``clear()`` drops nothing of them."""

    def __init__(self, probe):
        super().__init__()
        self._probe = probe

    def append(self, event):
        kind, _, t_disp, t_end = event
        if kind == "dev":
            with self._probe._lock:
                self._probe.blocks.append((t_disp, t_end))

    def clear(self):
        pass


class Probe:
    """Spans (host clock, ``time.perf_counter``) of the program's layers and
    the sizes their calls were given, gathered from every thread; each
    device block's dispatch and emitted times (``time.time``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._undo: list[tuple[object, str, object]] = []
        self.clear()

    def clear(self):
        """Drop what was recorded so far; the wrappers stay."""
        self.spans: dict[str, list[tuple[float, float, int]]] = defaultdict(list)
        self.sizes: dict[str, list[int]] = defaultdict(list)
        self.blocks: list[tuple[float, float]] = []

    def _span(self, name, fn, size_arg=None):
        probe = self

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                size = args[size_arg] if size_arg is not None and len(args) > size_arg else 0
                with probe._lock:
                    probe.spans[name].append((t0, t1, threading.get_ident()))
                    if size_arg is not None:
                        probe.sizes[name].append(int(size))
        return wrapped

    def _swap(self, owner, attr, new):
        self._undo.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, new)

    def install(self):
        from tpubz_torch.block import encode
        from tpubz_torch.stream import api

        enc = encode.DeviceBlockEncoder
        for attr in ("transform", "transform_bwt", "fetch_async", "fetch_bwt_async"):
            self._swap(enc, attr, self._span("dispatch", enc.__dict__[attr]))
        emit = enc.__dict__["emit_block"].__func__
        self._swap(enc, "emit_block", staticmethod(self._span("emit", emit, size_arg=2)))
        self._swap(api, "mtf_rle2_native", self._span("host_mtf_rle2", api.mtf_rle2_native))
        self._swap(api, "last_stream_events", _StreamEvents(self))
        self._swap(encode, "bwt_forward_async", self._span("bwt", encode.bwt_forward_async, 1))
        return self

    def uninstall(self):
        while self._undo:
            owner, attr, old = self._undo.pop()
            setattr(owner, attr, old)

    def mean_size(self, name: str) -> float | None:
        sizes = self.sizes.get(name)
        return sum(sizes) / len(sizes) if sizes else None


def union_length(intervals, lo: float, hi: float) -> tuple[float, list[tuple[float, float]]]:
    """(covered length, the gaps) of intervals clipped to [lo, hi]."""
    covered, gaps, cur = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= cur:
            continue
        if a > cur:
            gaps.append((cur, a))
            cur = a
        covered += b - cur
        cur = b
    if cur < hi:
        gaps.append((cur, hi))
    return covered, gaps


class Timeline:
    """The device intervals of a profiler session, in seconds on the
    profiler's clock."""

    def __init__(self, prof):
        self.ops: list[tuple[str, float, float]] = []  # (name, start, end) on the card
        self.cpu: dict[str, list[tuple[float, float]]] = defaultdict(list)
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                self.ops.append((e.name(), start, end))
            elif e.name().startswith("bz."):
                self.cpu[e.name()].append((start, end))
        self.ops.sort(key=lambda o: o[1])

    def bwt_spans(self) -> list[tuple[float, float]]:
        """Each BWT call from its ``bwt_setup`` kernel's start to the next
        ``bwt_last_column`` kernel's end."""
        spans, open_at = [], None
        for name, a, b in self.ops:
            if "bwt_setup" in name:
                open_at = a
            elif "bwt_last_column" in name and open_at is not None:
                spans.append((open_at, b))
                open_at = None
        return spans

    def busy(self, lo: float, hi: float):
        """(busy seconds, gaps) of the card over [lo, hi]: every traced
        kernel, copy and set, and every BWT call's span."""
        return union_length([(a, b) for _, a, b in self.ops] + self.bwt_spans(), lo, hi)

    def bwt_s(self, lo: float, hi: float) -> tuple[float, int]:
        """(seconds, calls) of the BWT calls' spans started in [lo, hi]."""
        spans = [(a, b) for a, b in self.bwt_spans() if lo <= a < hi]
        return sum(b - a for a, b in spans), len(spans)

    def kernel_s(self, lo: float, hi: float, names) -> tuple[float, dict]:
        """(seconds, launches by name) of the kernels whose names hold one
        of ``names``, started in [lo, hi]."""
        total, count = 0.0, dict.fromkeys(names, 0)
        for name, a, b in self.ops:
            hit = next((k for k in names if k in name), None)
            if hit is not None and lo <= a < hi:
                total += b - a
                count[hit] += 1
        return total, count

    def top_ops(self, lo: float, hi: float, k: int = 10) -> list[list]:
        """The k device operations (by name) that took the most time in
        [lo, hi], with the BWT calls' spans as one entry."""
        by = defaultdict(float)
        for name, a, b in self.ops:
            if lo <= a < hi:
                by[name] += b - a
        by["bwt call, bwt_setup to bwt_last_column (its graph inside)"] = sum(
            b - a for a, b in self.bwt_spans() if lo <= a < hi)
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


def name_gaps(gaps, files, dispatch, k: int = 10) -> list[list]:
    """The card's idle seconds by what the host was doing, on one clock:
    ``files`` the (start, end) of each ``compress`` call in flight,
    ``dispatch`` the dispatchers' spans."""
    by = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        if not any(s <= mid <= e for s, e in files):
            kind = "between files (no compress call in flight)"
        elif any(s <= mid <= e for s, e, *_ in dispatch):
            kind = "dispatcher's host work (upload, launches, copies' enqueue)"
        else:
            kind = "no dispatcher working (a file's fill or drain, or the window full)"
        by[kind] += b - a
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

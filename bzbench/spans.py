"""The port's own spans (``tpubz_torch.spans``) as the metrics read them.

A run that recorded them carries ``run.spans`` (the recorder's records:
``name``, ``start_ns`` and ``end_ns`` on ``time.perf_counter_ns``'s clock,
``cpu_ns``, ``thread``, ``stream``, ``block``, ``parent``, ``id``,
``attrs``) and, when the profiler traced it, ``run.clock_offset``: the
profiler's clock less the host's, in seconds, from the anchors that tie the
two (``run.py:_read_timeline``'s median). A run without them (untraced, or
a program without ``tpubz_torch.spans``) gives every reader here None.

``idle_split`` puts the card's idle time in the traced span into exclusive
buckets, by interval overlap: the first that applies wins. ``dispatch``: a
``dispatch`` span is open. ``file_edges``: the caller is in a stream's
``stream.setup``, ``stream.fill`` or ``stream.finish``, or no ``stream`` is
open (between files). ``rest``: the card idles while the host is in none of
these (the drain waits on blocks in flight, or the window is full).
"""
from __future__ import annotations

import statistics
from collections import defaultdict

EDGES = ("stream.setup", "stream.fill", "stream.finish")


def records(run) -> list | None:
    """The run's span records, or None when it recorded none."""
    spans = getattr(run, "spans", None)
    return spans or None


def named(run, name: str) -> list:
    return [s for s in records(run) or () if s.name == name]


def ms(span) -> float:
    return (span.end_ns - span.start_ns) * 1e-6


def median_ms(values) -> float | None:
    values = list(values)
    return statistics.median(values) if values else None


def mean_ms(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None


def per_stream_ms(run, name: str) -> list[float]:
    """Each stream's summed ``name`` spans in ms, for every stream that has a
    ``stream`` span (a stream with none of them counts 0)."""
    total = defaultdict(float)
    for s in named(run, name):
        total[s.stream] += ms(s)
    return [total[s.stream] for s in named(run, "stream")]


def self_ms(run, name: str) -> list[float]:
    """Each ``name`` span's self time in ms: its length less its children's
    (the spans whose parent it is, on its thread)."""
    children = defaultdict(float)
    for s in records(run) or ():
        if s.parent is not None:
            children[s.parent] += ms(s)
    return [ms(s) - children[s.id] for s in named(run, name)]


def on_profiler_clock(run, names) -> list[tuple[float, float]]:
    """The (start, end) seconds of the spans named in ``names`` on the
    profiler's clock."""
    off = run.clock_offset
    return [(s.start_ns * 1e-9 + off, s.end_ns * 1e-9 + off)
            for s in records(run) or () if s.name in names]


def idle_split(gaps, dispatch, edges, streams) -> dict[str, float]:
    """Seconds of the idle ``gaps`` in each bucket (module docstring), from
    interval sets on one clock; the buckets add up to the gaps' length."""
    events = []
    for kind, intervals in (("idle", gaps), ("dispatch", dispatch), ("edge", edges),
                            ("stream", streams)):
        for a, b in intervals:
            if b > a:
                events.append((a, 1, kind))
                events.append((b, -1, kind))
    events.sort(key=lambda e: e[0])
    depth = dict.fromkeys(("idle", "dispatch", "edge", "stream"), 0)
    out = dict.fromkeys(("dispatch", "file_edges", "rest"), 0.0)
    prev = None
    for t, step, kind in events:
        if prev is not None and t > prev and depth["idle"] > 0:
            if depth["dispatch"] > 0:
                out["dispatch"] += t - prev
            elif depth["edge"] > 0 or depth["stream"] == 0:
                out["file_edges"] += t - prev
            else:
                out["rest"] += t - prev
        depth[kind] += step
        prev = t
    return out


def _traced(run) -> bool:
    """Whether the run has spans, a traced span and its clock offset."""
    return (records(run) is not None and getattr(run, "clock_offset", None) is not None
            and getattr(run, "timeline", None) is not None and run.traced_span is not None)


def idle_shares(run) -> dict[str, float] | None:
    """Each bucket's share of the traced span, in %, or None without a
    traced span, its clock offset or spans."""
    if not _traced(run):
        return None
    lo, hi = run.traced_span
    _, gaps = run.timeline.busy(lo, hi)
    split = idle_split(gaps, on_profiler_clock(run, ("dispatch",)),
                       on_profiler_clock(run, EDGES), on_profiler_clock(run, ("stream",)))
    return {k: 100.0 * v / (hi - lo) for k, v in split.items()}


def bwt_in_traced_span(run) -> dict | None:
    """The BWT calls that the profiler traced, timed both ways: the mean of
    the card's own ``bwt_device_ns`` over the blocks dispatched and fetched
    inside the traced span, and the mean span from ``bwt_setup`` to
    ``bwt_last_column`` in the profiler's timeline (``bwt_roofline``'s), in
    ms. None without a traced span, its clock offset or spans."""
    if not _traced(run):
        return None
    lo, hi = run.traced_span
    off = run.clock_offset
    inside = {(s.stream, s.block) for s in named(run, "dispatch")
              if s.start_ns * 1e-9 + off >= lo}
    card = [s.attrs.get("bwt_device_ns") for s in named(run, "fetch.wait")
            if (s.stream, s.block) in inside and s.end_ns * 1e-9 + off <= hi]
    card = [v * 1e-6 for v in card if v]
    secs, calls = run.timeline.bwt_s(lo, hi)
    return {"card_ms": mean_ms(card), "card_calls": len(card),
            "profiler_ms": 1e3 * secs / calls if calls else None, "profiler_calls": calls}

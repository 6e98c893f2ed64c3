"""A run of a cell with the port's own spans recorded over its window.

    python3 bzbench/span_run.py --workload <config>.<traffic> --seed N --seconds S --trace 0|1

(or ``python3 -m bzbench.span_run ...``) from the root of a checkout: the
run of ``run.py``, its checks and its result line, with the port's span
recorder (``tpubz_torch.spans``) started at the window's first file and
stopped when the run has ended, and the metrics of ``span_metrics.json``
read from its spans (``bzbench/metrics/<name>.py``) and added to the
result's ``metrics``. ``detail.idle_split_pct`` gives the card's idle share
of the traced span in all three buckets of ``spans.idle_split``, and
``detail.bwt_in_traced_span`` the traced calls' mean time by the card's
clock beside the profiler's (``spans.bwt_in_traced_span``). With
``--trace 1`` the span metrics sit beside ``run.py``'s traced ones, on the
profiler's clock (the device ones need a card); with ``--trace 0`` no probe
and no profiler run, and the recorder's cost is the rate against an
untraced ``run.py`` run. A program without ``tpubz_torch.spans`` records
nothing: the result comes without the span metrics.

``run.py`` records no program span itself: this file wraps its window's
``compress`` (``run_cell``'s ``wrap``) to start the recorder, and its
``_read_timeline`` to keep the clock offset, and puts ``spans`` and
``clock_offset`` on its ``Run``.
"""
from __future__ import annotations

import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bzbench import run as bzrun  # noqa: E402  (run.py's clock of set-up starts here)

import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402

from bzbench import spans as sp  # noqa: E402


def _port_spans():
    """The port's recorder module, or None for a program without one."""
    try:
        return importlib.import_module("tpubz_torch.spans")
    except ImportError:
        return None


def run_with_spans(run_cell, workload: str, seed: int, seconds: float, trace: bool, *,
                   root: str = bzrun.ROOT, device: str | None = None, wrap=None) -> dict:
    """``run_cell`` (``run.py``'s) with the recorder on over the window;
    the result with the span metrics added."""
    port = _port_spans()
    held = {}
    read_timeline = bzrun._read_timeline

    def keep_offset(run, session, tr):
        out = read_timeline(run, session, tr)
        timeline, anchors = session
        marks = timeline.cpu.get("bz.anchor", [])
        if run.traced_span is not None:
            held["run"] = run
            held["offset"] = statistics.median(m[0] - a for m, a in zip(marks, anchors))
        return out

    def recorded(compress):
        inner = compress if wrap is None else wrap(compress)
        calls = [0]

        def window_call(data, level, device):
            calls[0] += 1
            if calls[0] == 2 and port is not None:  # the first file of the window
                port.start()
            return inner(data, level, device=device)
        return window_call

    bzrun._read_timeline = keep_offset
    try:
        result = run_cell(workload, seed, seconds, trace, root=root, device=device,
                          wrap=recorded)
    finally:
        bzrun._read_timeline = read_timeline
        rec = port.stop() if port is not None else None
    if rec is None:
        return result
    run = held.get("run") or bzrun.Run()
    run.spans, run.clock_offset = rec.spans, held.get("offset")
    with open(os.path.join(root, "bzbench", "span_metrics.json")) as f:
        specs = json.load(f)
    for spec in specs:
        value = bzrun.load_reader(spec["name"], root)(run)
        if value is not None:
            result["metrics"][spec["name"]] = {"value": value, "unit": spec["unit"]}
    result["detail"]["spans_recorded"] = len(rec.spans)
    result["detail"]["idle_split_pct"] = sp.idle_shares(run)
    result["detail"]["bwt_in_traced_span"] = sp.bwt_in_traced_span(run)
    result["checks"] = result.pop("checks")  # the numbers compared stay last
    return result


def main(argv=None, *, root: str = bzrun.ROOT, device: str | None = None) -> int:
    """``run.py``'s command, its run recording the port's spans."""
    run_cell = bzrun.run_cell
    bzrun.run_cell = lambda *a, **kw: run_with_spans(run_cell, *a, **kw)
    try:
        return bzrun.main(argv, root=root, device=device)
    finally:
        bzrun.run_cell = run_cell


if __name__ == "__main__":
    sys.exit(main())

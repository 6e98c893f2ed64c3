"""The readers of the port's own spans on the CPU: the split of the card's
idle time, and runs of a small cell with the recorder on (``span_run.py``),
with a program that has the recorder and with one that lacks it."""
import json
import os
import sys
from types import SimpleNamespace

import pytest

from bzbench import run, span_run
from bzbench import spans as sp

with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "span_metrics.json")) as f:
    SPECS = json.load(f)
NAMES = [m["name"] for m in SPECS]
DEVICE = {"bwt.call_ms", "device.idle_dispatch_pct", "device.idle_file_edges_pct"}


def _span(name, a, b, *, sid=1, block=-1, cpu=None, parent=None, ident=0, **attrs):
    """A record as the port's recorder keeps it, a and b in seconds."""
    return SimpleNamespace(name=name, start_ns=int(a * 1e9), end_ns=int(b * 1e9),
                           cpu_ns=int((b - a) * 1e9) if cpu is None else cpu, stream=sid,
                           block=block, parent=parent, id=ident, thread=1, attrs=attrs)


def test_idle_split_is_exclusive_and_by_overlap():
    gaps = [(0.0, 1.0), (2.0, 4.0), (5.0, 6.0)]
    dispatch = [(0.5, 2.5)]
    edges = [(0.2, 0.8), (3.0, 3.5)]
    streams = [(0.1, 3.8)]
    got = sp.idle_split(gaps, dispatch, edges, streams)
    # [0, 0.1) no stream, [0.1, 0.2) rest, [0.2, 0.5) edge, [0.5, 1) and [2, 2.5)
    # dispatch, [2.5, 3) rest, [3, 3.5) edge, [3.5, 3.8) rest, [3.8, 4) and [5, 6)
    # no stream
    assert got == pytest.approx({"dispatch": 1.0, "file_edges": 1.0 + 0.1 + 0.3 + 0.5 + 0.2,
                                 "rest": 0.1 + 0.5 + 0.3})
    assert sum(got.values()) == pytest.approx(4.0)
    # a gap whose midpoint falls in a dispatch span is not all the dispatcher's
    assert sp.idle_split([(0.0, 1.0)], [(0.4, 0.6)], [], [(0.0, 1.0)]) == pytest.approx(
        {"dispatch": 0.2, "file_edges": 0.0, "rest": 0.8})


class _Timeline:
    def __init__(self, gaps):
        self.gaps = gaps

    def busy(self, lo, hi):
        return hi - lo - sum(b - a for a, b in self.gaps), self.gaps


def test_idle_shares_map_spans_by_the_clock_offset():
    """Spans at host seconds 10.x land on a profiler clock 100 s ahead."""
    records = [_span("stream", 10.0, 10.6, ident=1),
               _span("stream.setup", 10.0, 10.1, parent=1, ident=2),
               _span("dispatch", 10.2, 10.3, block=0, ident=3)]
    run_ = run.Run(spans=records, clock_offset=100.0, timeline=_Timeline(
        [(110.05, 110.25), (110.5, 110.8)]), traced_span=(110.0, 111.0))
    got = sp.idle_shares(run_)
    assert got == pytest.approx({"dispatch": 5.0, "file_edges": 5.0 + 20.0, "rest": 10.0 + 10.0})
    assert run.load_reader("device.idle_dispatch_pct")(run_) == pytest.approx(5.0)
    assert run.load_reader("device.idle_file_edges_pct")(run_) == pytest.approx(25.0)
    run_.clock_offset = None
    assert sp.idle_shares(run_) is None


def test_readers_of_spans():
    records = [
        _span("stream", 0, 1.0, sid=1, ident=1), _span("stream", 2, 3.0, sid=2, ident=2),
        _span("stream.setup", 0, 0.002, sid=1), _span("stream.setup", 2, 2.004, sid=2),
        _span("stream.fill", 0.1, 0.2, sid=1), _span("stream.fill", 0.3, 0.31, sid=1),
        _span("stream.fill", 2.1, 2.13, sid=2),
        _span("stream.finish", 0.9, 1.0, sid=1), _span("stream.finish", 2.9, 2.92, sid=2),
        _span("dispatch", 0.2, 0.204, block=0, ident=10, cpu=3_000_000),
        _span("dispatch.upload", 0.2, 0.201, block=0, parent=10),
        _span("dispatch.copies", 0.203, 0.2035, block=0, parent=10),
        _span("dispatch", 0.3, 0.302, block=1, ident=11, cpu=1_000_000),
        _span("dispatch.upload", 0.3, 0.3005, block=1, parent=11),
        _span("dispatch.copies", 0.301, 0.3015, block=1, parent=11),
        _span("fetch.wait", 0.4, 0.401, block=0, bwt_device_ns=1_900_000),
        _span("fetch.wait", 0.5, 0.503, block=1, bwt_device_ns=2_100_000),
    ]
    run_ = run.Run(spans=records)
    want = {"stream.setup_ms": 3.0, "stream.fill_ms": (110 + 30) / 2, "stream.finish_ms": 60.0,
            "dispatch.upload_ms": 0.75, "dispatch.launch_ms": (2.5 + 1.0) / 2,
            "dispatch.copies_ms": 0.5, "dispatch.offcpu_pct": 100 * (1 - 4 / 6),
            "fetch.wait_ms": 2.0, "bwt.call_ms": 2.0}
    for name, value in want.items():
        assert run.load_reader(name)(run_) == pytest.approx(value), name
    # the parts of a dispatch add up to it
    parts = sum(run.load_reader(k)(run_) for k in ("dispatch.upload_ms", "dispatch.launch_ms",
                                                   "dispatch.copies_ms"))
    assert parts == pytest.approx(3.0)
    # a run with no spans (an untraced run, or a program without the recorder)
    for name in NAMES:
        assert run.load_reader(name)(run.Run()) is None


def test_span_metrics_would_fit_the_manifest():
    """Each entry is a per-layer metric of the manifest's form, with a
    reader, a layer the manifest names or a new one, and a cell there."""
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    cells = {w["name"] for w in bench["workloads"]}
    taken = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for m in SPECS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["name"] not in taken and m["moves"] == "encode_MBps"
        assert set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(run.ROOT, "bzbench", "metrics", m["name"] + ".py"))


def _span_run(bench_root, capsys):
    rc = span_run.main(["--workload", "bz1-small.history-small", "--seed", str(2**31 + 77),
                        "--seconds", "2", "--trace", "1"], root=bench_root, device="cpu")
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


def test_a_traced_cpu_run_reads_the_host_spans(bench_root, capsys):
    result = _span_run(bench_root, capsys)
    assert result["correct"] and list(result)[-1] == "checks"
    metrics = result["metrics"]
    for name in set(NAMES) - DEVICE:
        assert metrics[name]["value"] >= 0, name
    assert not DEVICE & set(metrics)  # no card: no device time, no profiler
    assert metrics["stream.setup_ms"]["unit"] == "ms"
    assert result["detail"]["spans_recorded"] > 0
    assert "tpubz_torch.spans" in sys.modules and not sys.modules["tpubz_torch.spans"]._on


def test_a_program_without_the_recorder_still_gives_a_result(bench_root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "tpubz_torch.spans", None)  # import fails, as at the parent
    result = _span_run(bench_root, capsys)
    assert result["correct"] and not set(NAMES) & set(result["metrics"])
    assert "block.dispatch_ms" in result["metrics"] and "spans_recorded" not in result["detail"]


def test_bwt_calls_in_the_traced_span_both_ways():
    """Only the blocks dispatched and fetched inside the traced span count
    on the card's side; the profiler's side is bwt_roofline's spans."""
    records = [_span("dispatch", 9.9, 9.95, block=0), _span("fetch.wait", 10.0, 10.01, block=0,
                                                             bwt_device_ns=5_000_000),
               _span("dispatch", 10.1, 10.11, block=1), _span("fetch.wait", 10.2, 10.21, block=1,
                                                               bwt_device_ns=2_000_000),
               _span("dispatch", 10.8, 10.81, block=2), _span("fetch.wait", 11.2, 11.21, block=2,
                                                               bwt_device_ns=9_000_000)]
    timeline = SimpleNamespace(bwt_s=lambda lo, hi: (0.0042, 2))
    run_ = run.Run(spans=records, clock_offset=100.0, timeline=timeline,
                   traced_span=(110.0, 111.0))
    assert sp.bwt_in_traced_span(run_) == pytest.approx(
        {"card_ms": 2.0, "card_calls": 1, "profiler_ms": 2.1, "profiler_calls": 2})
    assert sp.bwt_in_traced_span(run.Run(spans=records)) is None

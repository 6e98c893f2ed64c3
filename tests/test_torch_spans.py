"""The port's span recorder (``tpubz_torch.spans``) on the CPU.

The streams run at level 1 on ``device="cpu"`` with ``TPUBZ_HYBRID_CPU=0``
and ``TPUBZ_DEVICE_STAGE=full``, so that every block goes through the
dispatcher, fetch and emit pools: one input above 4 x 99,981 bytes, which
the RLE1 feed scans, and one below it, whose blocks are a list.
"""
import threading
import time
from collections import Counter

import pytest
import torch

import tpubz_torch
from tpubz_torch import spans
from tpubz_torch.corpus import mixed_corpus
from tpubz_torch.format.constants import block_budget
from tpubz_torch.stream import api

# the test workers share the host's cores: keep torch's intra-op pool small
torch.set_num_threads(2)

SIZES = {"feed": 450_000, "list": 350_000}
STREAM = ("stream", "stream.setup", "stream.finish")
BLOCK = ("dispatch", "dispatch.upload", "dispatch.copies", "fetch.wait")


@pytest.fixture(autouse=True)
def full_stage(tmp_path, monkeypatch):
    from tpubz_torch.stream import rigprofile

    monkeypatch.setenv("TPUBZ_TORCH_CACHE", str(tmp_path / "torch_cache"))
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "0")
    monkeypatch.setenv("TPUBZ_DEVICE_STAGE", "full")
    rigprofile.reset_memo()
    yield
    rigprofile.reset_memo()


def _data(path: str, seed: int = 11) -> bytes:
    d = mixed_corpus(1, seed)[: SIZES[path]]
    assert (len(d) > 4 * block_budget(1)) == (path == "feed")
    return d


@pytest.fixture(scope="module", params=sorted(SIZES))
def traced(request, tmp_path_factory):
    """One stream of each path compressed with recording on, between two
    perf_counter readings, and once with it off; its blocks' events."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TPUBZ_TORCH_CACHE", str(tmp_path_factory.mktemp("cache")))
    mp.setenv("TPUBZ_HYBRID_CPU", "0")
    mp.setenv("TPUBZ_DEVICE_STAGE", "full")
    try:
        data = _data(request.param)
        off = tpubz_torch.compress(data, 1, device="cpu")
        with spans.recording() as rec:
            t0 = time.perf_counter_ns()
            on = tpubz_torch.compress(data, 1, device="cpu")
            t1 = time.perf_counter_ns()
        events = list(api.last_stream_events)
    finally:
        mp.undo()
    return {"data": data, "off": off, "on": on, "spans": rec.spans, "t": (t0, t1),
            "events": events}


def _blocks(records) -> int:
    (whole,) = [s for s in records if s.name == "stream"]
    return whole.attrs["blocks"]


@pytest.mark.parametrize("path", sorted(SIZES))
def test_nothing_is_recorded_while_off(path):
    rec = spans.start()
    spans.stop()
    assert spans.span("dispatch", stream=1, block=0) is spans._OFF
    assert spans.now() is None and spans.new_stream() == 0
    tpubz_torch.compress(_data(path), 1, device="cpu")
    assert rec.spans == [] and spans._stack() == []


def test_one_span_of_each_kind_per_call_and_per_block(traced):
    records = traced["spans"]
    n = _blocks(records)
    assert n >= 3 and {s.block for s in records if s.name in BLOCK} == set(range(n))
    kinds = Counter(s.name for s in records)
    assert all(kinds[k] == 1 for k in STREAM)
    assert all(kinds[k] == n for k in BLOCK)
    # the fill waits: one request a block and the one that ends the items
    assert kinds["stream.fill"] == n + 1
    per_block = Counter((s.name, s.block) for s in records if s.name in BLOCK)
    assert set(per_block.values()) == {1}
    (whole,) = [s for s in records if s.name == "stream"]
    assert whole.attrs["bytes"] == len(traced["data"]) and whole.attrs["stage"] == "full"
    dispatch = {s.block: s for s in records if s.name == "dispatch"}
    assert all(dispatch[b].attrs["n"] > 0 for b in range(n))


def test_children_lie_inside_their_parents_on_one_thread(traced):
    records = traced["spans"]
    by_id = {s.id: s for s in records}
    for s in records:
        assert s.start_ns <= s.end_ns and s.cpu_ns >= 0
        if s.parent is None:
            continue
        up = by_id[s.parent]
        assert up.thread == s.thread
        assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    parent = {s.name: by_id[s.parent].name for s in records if s.parent is not None}
    assert parent == {"stream.setup": "stream", "stream.fill": "stream",
                      "stream.finish": "stream", "dispatch.upload": "dispatch",
                      "dispatch.copies": "dispatch"}
    assert all(s.parent is None for s in records if s.name in ("stream", "dispatch",
                                                                "fetch.wait"))


def test_the_calls_spans_share_its_stream_id(traced):
    records = traced["spans"]
    (whole,) = [s for s in records if s.name == "stream"]
    assert whole.stream > 0 and {s.stream for s in records} == {whole.stream}
    threads = {s.name: s.thread for s in records}
    assert threads["dispatch"] != threads["stream"] != threads["fetch.wait"]


def test_bytes_with_recording_on_equal_off_and_the_cpu_engine(traced):
    assert traced["on"] == traced["off"] == tpubz_torch.compress_cpu(traced["data"], 1)


def test_spans_and_events_lie_inside_the_call(traced):
    t0, t1 = traced["t"]
    assert all(t0 <= s.start_ns <= s.end_ns <= t1 for s in traced["spans"])
    setup, fill, finish = (sorted((s for s in traced["spans"] if s.name == k),
                                  key=lambda s: s.start_ns)
                           for k in ("stream.setup", "stream.fill", "stream.finish"))
    assert setup[0].end_ns <= fill[0].start_ns and fill[-1].start_ns <= finish[0].start_ns
    # last_stream_events on the recorder's clock: every device block, dispatched
    # before it was emitted, inside the call
    events = traced["events"]
    assert sorted(i for kind, i, _, _ in events if kind == "dev") == list(
        range(_blocks(traced["spans"])))
    assert all(t0 * 1e-9 <= a <= b <= t1 * 1e-9 for _, _, a, b in events)


def test_two_streams_at_once_keep_their_own_ids():
    datas = [_data("feed", 21), _data("list", 22)]
    outs = [None, None]

    def one(k):
        outs[k] = tpubz_torch.compress(datas[k], 1, device="cpu")

    with spans.recording() as rec:
        threads = [threading.Thread(target=one, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert outs == [tpubz_torch.compress_cpu(d, 1) for d in datas]
    ids = sorted({s.stream for s in rec.spans})
    assert len(ids) == 2 and 0 not in ids
    for sid in ids:
        mine = [s for s in rec.spans if s.stream == sid]
        n = _blocks(mine)
        kinds = Counter(s.name for s in mine)
        assert all(kinds[k] == 1 for k in STREAM) and all(kinds[k] == n for k in BLOCK)
        (whole,) = [s for s in mine if s.name == "stream"]
        assert {s.thread for s in mine if s.name.startswith("stream")} == {whole.thread}


def test_parents_are_per_thread_and_a_span_may_start_earlier():
    with spans.recording() as rec:
        with spans.span("a", stream=7, block=3) as a:
            mark = spans.now()
            time.sleep(0.002)
            with spans.span("b"):
                seen = []
                t = threading.Thread(target=lambda: seen.append(spans.span("c").start()))
                t.start()
                t.join(timeout=10)
                seen[0].end()
            with spans.span("d", at=mark) as d:
                d.set(k=1)
    got = {s.name: s for s in rec.spans}
    assert got["b"].parent == a.id and (got["b"].stream, got["b"].block) == (7, 3)
    assert got["c"].parent is None and (got["c"].stream, got["c"].block) == (0, -1)
    assert got["d"].start_ns == mark[0] and got["d"].end_ns - got["d"].start_ns >= 2_000_000
    assert got["d"].attrs == {"k": 1} and got["a"].parent is None


def test_a_span_that_ends_after_stop_is_not_kept_and_start_twice_raises():
    rec = spans.start()
    try:
        with pytest.raises(RuntimeError):
            spans.start()
        late = spans.span("late").start()
        with spans.span("kept"):
            pass
    finally:
        assert spans.stop() is rec
    late.end()
    assert [s.name for s in rec.spans] == ["kept"] and spans._stack() == []
    assert spans.stop() is None


def test_an_idle_site_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("an idle span site read a clock")

    monkeypatch.setattr(spans.time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(spans.time, "thread_time_ns", no_clock)
    with spans.span("dispatch", stream=1, block=2) as sp:
        assert not sp
        sp.set(n=1)
    spans.span("stream.setup").start().end()
    assert spans.now() is None

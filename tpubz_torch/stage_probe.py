"""Where a level-9 stream's time goes on the card, route by route.

    python3 -m tpubz_torch.stage_probe [--mib 16] [--seed 2026] [--out FILE]
                                       [--mode all|bwt_anatomy|devrefine|lean]
                                       [--parent DIR [--reps 1]]

Needs a CUDA card: without one it exits with code 1. The functions take a
device, so the CPU tests run them at a small size. It encodes the seeded
mixed corpus plus the edge blocks (``tpubz_torch.corpus``, as
``chip_smoke.py`` does) and prints one JSON object, also written to
``--out``:

- ``stages``: milliseconds per block of each stage of the full device chain
  on the dispatcher thread (upload, BWT, MTF, RLE2, fetch), host clock
  with ``torch.cuda.synchronize()`` after each stage, and of the native
  emission; medians and sums over the blocks, the first block excluded;
- ``bwt_stages``: the same for the bwt stage: upload, BWT and ``fetch_bwt``
  on the dispatcher, then the native MTF/RLE2 and emission on the host;
- ``profile``: one device-only stream per stage under ``torch.profiler``:
  wall ms, device busy ms (the union of kernel and copy intervals), the
  idle share, the kernels with the most device time, and the device ms and
  launches of each of the BWT's kernels (its own and the radix passes);
- ``window``: device-only full-stage stream MB/s for each ordered-drain
  window, and of the native host engine (``compress_cpu``), in turns;
- ``routes``: stream MB/s of the device-only ``full`` and ``bwt`` stages,
  the default hybrid and ``compress_cpu``, in turns, with each stream's
  ``last_stream_stats``;
- ``hybrid``: a sweep of the CPU pool (``TPUBZ_HYBRID_CPU``: 0, a quarter,
  half, 1x, 2x and 3x the cores) by the hybrid window (``TPUBZ_WINDOW``)
  for each stage, with MB/s, ``dev_blocks`` and ``cpu_blocks``;
- ``probation``: the same for 1x the cores and window 16 by the cap on
  device blocks in flight before a stream's first device completion;
- ``chain``: the device microseconds of each kernel that one ``mtf_ranks``
  and one ``rle2_encode_used`` call (RLE2 as the transform calls it)
  launch on the corpus's first block, from ``torch.profiler``;
- ``bwt_anatomy`` (alone with ``--mode bwt_anatomy``): of one
  ``bwt_forward`` call on the corpus's first block, the device
  microseconds and launches of each kernel (``bwt_setup``, ``bwt_keys``,
  ``bwt_pass``, ``bwt_small_sort``, ``bwt_rank_tiles``, ``bwt_rank_scan``,
  ``bwt_rank_apply``, ``bwt_round_end``, ``bwt_last_column``), per round
  and per radix pass, and the sort's (``bwt_pass`` and
  ``bwt_small_sort``), from ``torch.profiler``. The profiler may trace
  only some iterations of the graph's loop, so the traced launches are
  held to the call's own count (the body's launches from the card's
  record, the setup, the last column and the memset): on a shortfall
  ``complete`` is false and the per-kernel figures are null; the call's
  span on the card (``span_us``, CUDA events around it behind a sleeping
  stream, no profiler) is always given; the same for one ``radix_sort`` of the block's
  900,000 round-0 keys, ``torch.sort`` of them, and one
  ``bitonic_1op``, ``bitonic_2op`` and two-pass ``stage_passes`` call at
  2^20; per block of the data the doubling rounds, the active rotations
  sorted, the call's ms and the host's microseconds in it
  (``suffix_sort.HOST_US``: enqueueing, building a graph, the library
  call in all, and the wait for the call's event in ``finish``, which
  ``bwt_forward`` makes once a call); the host ms of the MTF and RLE2
  stages after the library call and after the plain version; and for one
  device-only stream per stage, with no profiler, the wall, the sum of each
  block's span on the card (CUDA events before its first kernel and after
  its copies are enqueued) and the share of the wall outside those spans;
- ``devrefine`` (also alone with ``--mode devrefine``): the device refine
  encoder (``DeviceBlockEncoder.encode_block_devrefine``) on every block
  of the data after its transform: host ms a block without a profiler,
  the refinement passes, a pass's host µs by part (``upload`` of its
  lengths, ``launch`` of ``refine_pass``, ``fetch`` of its selectors and
  frequencies with the wait, ``trees``: the six tree builds; from
  the encoder's ``devrefine_host_us``), and the functions with the most own time over
  all blocks under ``cProfile`` (which slows every Python call it sees:
  read the shares, not the sums);
- ``lean`` (also alone with ``--mode lean``): the full stage's two
  transfer forms (int16, its own, and the lean chain): device-only ``full`` streams of
  each in turns (int16, lean, lean, int16, ``--reps`` times, at least
  twice) with their MB/s and medians; and per block of the data, host ms
  of each form's fetch (the enqueue of the copies, the wait and the host's
  part: the lean form's count and patches) and, for the lean form, of the
  whole byte stream copied behind one event against the scalars first and
  then only the ``rle2_len`` bytes the stream fills;
- ``turns``: with ``--parent``, from a fresh process of the parent's tree
  and of this one in the order parent, this, this, parent (``--reps``
  times): ``bwt_forward``, ``mtf_ranks`` and ``rle2_encode`` ms on the
  corpus's first block (CUDA events, 20 calls back to back) and their
  device time (``torch.profiler``, one call), ``stages``, ``bwt_stages``,
  ``routes`` (two rounds) and one profiled device-only stream per stage
  (wall, device busy, idle share), each turn with a fresh rig profile. The
  parent is any checkout of the port, such as a ``git archive`` of an
  earlier commit unpacked into a directory that ``.gitignore`` lists.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .block.encode import DeviceBlockEncoder, block_n
from .corpus import edge_blocks, mixed_corpus
from .format.constants import block_budget
from .format.crc import block_crc
from .hostref.rle1 import rle1_blocks
from .kernels.mtf import mtf_ranks
from .kernels.rle2 import rle2_encode_used
from .kernels.suffix_sort import bwt_forward
from .native import mtf_rle2_native
from .stream import api

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = (2, 5, 28)
# the kernels of one bwt_forward call (csrc/bwt.cu, csrc/radix.cuh): the
# setup, then a round's (the large list's keys, its radix passes, the small
# list's shared-memory sort, the re-rank, the round's end), then the column
BWT_KERNELS = ("bwt_setup", "bwt_keys", "bwt_pass", "bwt_small_sort", "bwt_rank_tiles",
               "bwt_rank_scan", "bwt_rank_apply", "bwt_round_end", "bwt_last_column")
HYBRID_WINDOWS = (5, 16, 28)


def _timed(fn, device):
    """(result, host ms) of fn, with the device drained before and after."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def env(**overrides):
    """os.environ with the given TPUBZ_* overrides (None unsets), restored."""
    saved = {k: os.environ.get(k) for k in overrides}
    try:
        for k, v in overrides.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


DEVICE_ONLY = {
    "full": {"TPUBZ_HYBRID_CPU": 0, "TPUBZ_DEVICE_STAGE": "full"},
    "bwt": {"TPUBZ_HYBRID_CPU": 0, "TPUBZ_DEVICE_STAGE": "bwt"},
}


def _summary(rows: list[dict]) -> dict:
    rows = rows[1:]  # the first block warms the allocator and the sorts
    return {
        "blocks_timed": len(rows),
        "median_ms": {k: statistics.median(r[k] for r in rows) for k in rows[0]},
        "sum_ms": {k: sum(r[k] for r in rows) for k in rows[0]},
    }


def _blocks(data: bytes, level: int):
    arr = np.frombuffer(data, np.uint8)
    out, blocks = rle1_blocks(arr, block_budget(level))
    for o0, o1, i0, i1 in blocks:
        yield out[o0:o1], block_crc(arr[i0:i1])


def stage_times(data: bytes, level: int, device) -> dict:
    enc = DeviceBlockEncoder(level, device)
    rows = []
    for blk, crc in _blocks(data, level):
        n = blk.size
        row = {}
        dev, row["upload"] = _timed(lambda: enc.upload(blk), device)
        (key, last), row["bwt"] = _timed(lambda: bwt_forward(dev, n), device)
        (ranks, used), row["mtf"] = _timed(lambda: mtf_ranks(last, n), device)
        rle, row["rle2"] = _timed(lambda: rle2_encode_used(ranks, n, used), device)
        fetched, row["fetch"] = _timed(lambda: enc.fetch((key, *rle, used)), device)
        row["dispatcher_total"] = sum(row.values())
        t0 = time.perf_counter()
        enc.emit_block(*fetched, crc)
        row["native_emit"] = (time.perf_counter() - t0) * 1e3
        rows.append(row)
    return _summary(rows)


def bwt_stage_times(data: bytes, level: int, device) -> dict:
    """Per-block ms of the bwt stage: the dispatcher's upload, BWT and
    fetch_bwt, then the host's native MTF/RLE2 and emission."""
    enc = DeviceBlockEncoder(level, device)
    rows = []
    for blk, crc in _blocks(data, level):
        n = blk.size
        row = {}
        dev, row["upload"] = _timed(lambda: enc.upload(blk), device)
        (key, last), row["bwt"] = _timed(lambda: bwt_forward(dev, n), device)
        fetched, row["fetch_bwt"] = _timed(lambda: enc.fetch_bwt((key, last, n)), device)
        row["dispatcher_total"] = sum(row.values())
        t0 = time.perf_counter()
        rle2, freqs, used = mtf_rle2_native(fetched[1])
        t1 = time.perf_counter()
        enc.emit_block(fetched[0], rle2, rle2.size, freqs, used, crc)
        t2 = time.perf_counter()
        row["native_mtf_rle2"] = (t1 - t0) * 1e3
        row["native_emit"] = (t2 - t1) * 1e3
        rows.append(row)
    return _summary(rows)


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_stream(data: bytes, level: int, device, stage: str = "full") -> dict:
    """One device-only stream of ``stage`` under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with env(**DEVICE_ONLY[stage]):
        api.compress(data, level, device=device)  # warm
        with profile(activities=acts) as prof:
            _, wall = _timed(lambda: api.compress(data, level, device=device), device)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3
    by_name: dict = {}
    for e in dev:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "stage": stage,
        "wall_ms": wall,
        "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall if dev else None,
        "device_events": len(dev),
        "top_kernels": [{"name": k[:120], "ms": ms, "count": c} for k, (ms, c) in top],
        "bwt_kernels": [{"name": k[:120], "ms": ms, "count": c} for k, (ms, c) in by_name.items()
                        if any(w in k for w in BWT_KERNELS)],
    }


def window_sweep(data: bytes, level: int, device, reps: int = 3) -> dict:
    """Device-only full-stage stream MB/s per ordered-drain window, and of
    the native host engine on the same machine's cores, in turns."""
    rates: dict = {w: [] for w in WINDOWS}
    host = []
    saved = api.WINDOW
    try:
        with env(**DEVICE_ONLY["full"]):
            for _ in range(reps):
                for w in WINDOWS:
                    api.WINDOW = w
                    _, ms = _timed(lambda: api.compress(data, level, device=device), device)
                    rates[w].append(len(data) / 1e3 / ms)
                t0 = time.perf_counter()
                api.compress_cpu(data, level)
                host.append(len(data) / 1e6 / (time.perf_counter() - t0))
    finally:
        api.WINDOW = saved
    return {"default": saved, "MBps": {str(w): r for w, r in rates.items()},
            "host_engine_MBps": host}


def _rate(data: bytes, run, device) -> dict:
    _, ms = _timed(run, device)
    return {"MBps": len(data) / 1e3 / ms, "stats": dict(api.last_stream_stats)}


def route_rates(data: bytes, level: int, device, reps: int = 3) -> dict:
    """Stream MB/s of the device-only full and bwt stages, the default
    hybrid and compress_cpu, taken in turns."""
    runs = {
        "full": (DEVICE_ONLY["full"], lambda: api.compress(data, level, device=device)),
        "bwt": (DEVICE_ONLY["bwt"], lambda: api.compress(data, level, device=device)),
        "hybrid": ({"TPUBZ_HYBRID_CPU": None, "TPUBZ_DEVICE_STAGE": None},
                   lambda: api.compress(data, level, device=device)),
        "compress_cpu": ({}, lambda: api.compress_cpu(data, level)),
    }
    out: dict = {name: [] for name in runs}
    for _ in range(reps):
        for name, (overrides, run) in runs.items():
            with env(**overrides):
                out[name].append(_rate(data, run, device))
    return out


def hybrid_sweep(data: bytes, level: int, device, reps: int = 3,
                 stages=("bwt", "full"), workers=None, windows=HYBRID_WINDOWS) -> dict:
    """MB/s, dev_blocks and cpu_blocks of hybrid streams per stage, CPU pool
    size (by default 0, a quarter, half, 1x, 2x and 3x the cores) and
    window."""
    cores = os.cpu_count() or 4
    rows = []
    for stage in stages:
        for workers_n in workers or (0, cores // 4, cores // 2, cores, 2 * cores, 3 * cores):
            for window in windows:
                with env(TPUBZ_DEVICE_STAGE=stage, TPUBZ_HYBRID_CPU=workers_n,
                         TPUBZ_WINDOW=window):
                    runs = [_rate(data, lambda: api.compress(data, level, device=device),
                                  device) for _ in range(reps)]
                rows.append({
                    "stage": stage, "cpu_workers": workers_n, "window": window,
                    "MBps": [r["MBps"] for r in runs],
                    "dev_blocks": [r["stats"]["dev_blocks"] for r in runs],
                    "cpu_blocks": [r["stats"]["cpu_blocks"] for r in runs],
                })
    return {"cores": cores, "rows": rows}


PROBATION_CAPS = (2, 4, 8, 16)


def probation_sweep(data: bytes, level: int, device, reps: int = 3,
                    caps=PROBATION_CAPS) -> dict:
    """MB/s and engines of hybrid streams (1x the cores, window 16) per
    stage and per cap on device blocks in flight before a stream's first
    device completion (``api.PROBATION_INFLIGHT``)."""
    cores = os.cpu_count() or 4
    rows = []
    saved = api.PROBATION_INFLIGHT
    try:
        for stage in ("bwt", "full"):
            for cap in caps:
                api.PROBATION_INFLIGHT = cap
                with env(TPUBZ_DEVICE_STAGE=stage, TPUBZ_HYBRID_CPU=cores, TPUBZ_WINDOW=16):
                    runs = [_rate(data, lambda: api.compress(data, level, device=device),
                                  device) for _ in range(reps)]
                rows.append({
                    "stage": stage, "cap": cap,
                    "MBps": [r["MBps"] for r in runs],
                    "dev_blocks": [r["stats"]["dev_blocks"] for r in runs],
                    "cpu_blocks": [r["stats"]["cpu_blocks"] for r in runs],
                })
    finally:
        api.PROBATION_INFLIGHT = saved
    return {"cores": cores, "default": saved, "rows": rows}


def kernel_device_us(fn) -> dict:
    """Device microseconds of one call of fn by kernel name, their sum and
    their union, from torch.profiler after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    counts: dict = {}
    for e in dev:
        by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + e.time_range.end - e.time_range.start
        counts[e.name[:100]] = counts.get(e.name[:100], 0) + 1
    return {"sum_us": sum(by_name.values()),
            "busy_us": _union_us((e.time_range.start, e.time_range.end) for e in dev),
            "launches": len(dev), "kernels_us": by_name, "kernels_launches": counts}


def _span_us(fn) -> float:
    """The card's µs from the first operation of one call of fn to its last:
    CUDA events around it, enqueued behind tens of ms of device work so that
    the host's enqueueing is hidden; what fn returns is held until the
    second event is recorded (a BWT call dropped unfinished waits)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    del out
    return a.elapsed_time(b) * 1e3


def chain_profile(mib: int, seed: int) -> dict:
    """Device µs by kernel of one mtf_ranks and one rle2_encode_used call
    (RLE2 as the transform calls it) on the BWT of the corpus's first
    level-9 block."""
    n = 900_000
    padded = torch.zeros(block_n(9), dtype=torch.uint8, device="cuda")
    padded[:n] = torch.frombuffer(bytearray(mixed_corpus(mib, seed)[:n]), dtype=torch.uint8).to("cuda")
    last = bwt_forward(padded, n)[1]
    ranks, used = mtf_ranks(last, n)
    return {"mtf": kernel_device_us(lambda: mtf_ranks(last, n)),
            "rle2": kernel_device_us(lambda: rle2_encode_used(ranks, n, used))}


def stream_spans(data: bytes, level: int, stage: str, device="cuda") -> dict:
    """One device-only stream of ``stage`` with no profiler: its wall, the
    sum of its blocks' spans on the card and the share of the wall outside
    them. A span runs from an event recorded before the block's transform
    to one recorded after its host copies are enqueued, both on the
    encoder's stream: device time in which the block's work was open, so an
    upper bound on the time the card was busy. On a CPU device the marks
    are host clock readings."""
    on_card = torch.device(device).type == "cuda"

    def mark():
        if not on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    spans = []
    saved = {name: getattr(DeviceBlockEncoder, name)
             for name in ("transform", "transform_bwt", "fetch_async", "fetch_bwt_async")}

    def opening(fn):
        def wrap(self, *args, **kwargs):
            spans.append([mark(), None])
            return fn(self, *args, **kwargs)
        return wrap

    def closing(fn):
        def wrap(self, *args):
            out = fn(self, *args)
            spans[-1][1] = mark()
            return out
        return wrap

    with env(**DEVICE_ONLY[stage]):
        api.compress(data, level, device=device)  # warm
        try:
            for name, fn in saved.items():
                wrapper = opening if name.startswith("transform") else closing
                setattr(DeviceBlockEncoder, name, wrapper(fn))
            _, wall = _timed(lambda: api.compress(data, level, device=device), device)
        finally:
            for name, fn in saved.items():
                setattr(DeviceBlockEncoder, name, fn)
    span = sum(a.elapsed_time(b) if on_card else (b - a) * 1e3 for a, b in spans)
    return {"stage": stage, "blocks": len(spans), "wall_ms": wall, "block_span_ms": span,
            "outside_spans_share": 1 - span / wall}


def _by_kernel(call: dict) -> dict:
    """A kernel_device_us result's microseconds and launches summed by kernel
    (the names of BWT_KERNELS; template arguments folded)."""
    out = {}
    for name, us in call["kernels_us"].items():
        key = next((k for k in BWT_KERNELS if k in name), name)
        n = call["kernels_launches"][name]
        prev = out.get(key, {"us": 0.0, "launches": 0})
        out[key] = {"us": prev["us"] + us, "launches": prev["launches"] + n}
    return out


def bwt_anatomy(data: bytes) -> dict:
    """Where one BWT call's device time goes (on the first 900,000 bytes of
    ``data``), what the radix sort, the sorts it replaced and its yardstick take on the same keys, how many rounds and
    active rotations each level-9 block of ``data`` runs, and how much of a
    device-only stream's wall lies outside its blocks' spans on the card."""
    from .kernels import bitonic, radix, suffix_sort

    n = 900_000
    padded = torch.zeros(block_n(9), dtype=torch.uint8, device="cuda")
    padded[:n] = torch.frombuffer(bytearray(data[:n]), dtype=torch.uint8).to("cuda")
    held = {}

    def one_call():
        held["call"] = suffix_sort.bwt_forward_async(padded, n)[2]
        held["call"].finish()

    # the profiler may see every iteration of a graph's loop only if its
    # tracing had started before the graph was instantiated: start it, then
    # build the call's graph for a stream of its own (the graphs are per
    # stream); `complete` says whether it did
    kernel_device_us(lambda: torch.ones(1, device="cuda").add_(1))
    with torch.cuda.stream(torch.cuda.Stream()):
        call = kernel_device_us(one_call)
    record = held["call"].rows[0]
    rounds = record["rounds"]
    # the call's launches as the card (the graph's body) and the host (the
    # setup, the last column and the memset) counted them
    counted = sum(record[k] for k in suffix_sort.BODY) + suffix_sort.launch_sizes()[1] + 1
    block0 = {"rounds": rounds, "active_rotations_sorted": record["active"], "call": call,
              "launches_counted": counted, "complete": call["launches"] == counted,
              "span_us": _span_us(lambda: suffix_sort.bwt_forward_async(padded, n))}
    if block0["complete"]:
        kernels = _by_kernel(call)
        passes = kernels.get("bwt_pass", {"us": 0.0, "launches": 0})
        small = kernels.get("bwt_small_sort", {"us": 0.0, "launches": 0})
        block0.update({"by_kernel": kernels, "us_per_round": call["sum_us"] / rounds,
                       "launches_per_round": call["launches"] / rounds,
                       "us_per_radix_pass": passes["us"] / max(passes["launches"], 1),
                       "sort_us": passes["us"] + small["us"]})
    else:
        block0.update(dict.fromkeys(("by_kernel", "us_per_round", "launches_per_round",
                                     "us_per_radix_pass", "sort_us")))
    k0 = suffix_sort.round_keys(padded[:n], 0)
    lo, hi = suffix_sort.KEY_LO, suffix_sort.KEY_HI
    k64 = torch.full((1 << 20,), torch.iinfo(torch.int64).max, dtype=torch.int64, device="cuda")
    k64[:n] = k0
    pos = torch.arange(k64.shape[0], dtype=torch.int32, device="cuda")
    k32 = (k64 >> 40).to(torch.int32)
    sorts = {
        "radix_sort": kernel_device_us(lambda: radix.radix_sort(k0, lo, hi)),
        "torch_sort": kernel_device_us(lambda: torch.sort(k0)),
        "bitonic_1op_i64": kernel_device_us(lambda: bitonic.bitonic_1op(k64)),
        "bitonic_2op_i64": kernel_device_us(lambda: bitonic.bitonic_2op(k64, pos)),
        "bitonic_2op_i32": kernel_device_us(lambda: bitonic.bitonic_2op(k32, pos)),
        "stage_passes_row2_i32": kernel_device_us(lambda: bitonic.stage_passes(k32.clone(), [19, 18])),
    }
    enc = DeviceBlockEncoder(9, "cuda")
    per_block = []
    for blk, _ in _blocks(data, 9):
        dev = enc.upload(blk)
        c0 = (suffix_sort.ROUNDS_RUN, suffix_sort.ACTIVE_SORTED, dict(suffix_sort.HOST_US))
        _, ms = _timed(lambda: bwt_forward(dev, blk.size), "cuda")
        per_block.append({"n": int(blk.size), "rounds": suffix_sort.ROUNDS_RUN - c0[0],
                          "active_rotations_sorted": suffix_sort.ACTIVE_SORTED - c0[1],
                          "call_ms": ms,
                          "host_us": {k: v - c0[2][k] for k, v in suffix_sort.HOST_US.items()}})
    # the host ms of the stages that follow the BWT, after the library call
    # and after the plain version (many small torch ops, the host busy
    # throughout), on the same blocks in turns
    after: dict = {"call": [], "plain": []}
    for blk, _ in list(_blocks(data, 9))[1:9]:
        dev = enc.upload(blk)
        for name, fn in (("call", bwt_forward), ("plain", suffix_sort.bwt_forward_ref)):
            (_, last), _ = _timed(lambda: fn(dev, blk.size), "cuda")
            (ranks, used), mtf_ms = _timed(lambda: mtf_ranks(last, blk.size), "cuda")
            _, rle2_ms = _timed(lambda: rle2_encode_used(ranks, blk.size, used), "cuda")
            after[name].append({"mtf": mtf_ms, "rle2": rle2_ms})
    return {
        "stages_after_bwt_median_ms": {
            name: {k: statistics.median(r[k] for r in rows) for k in ("mtf", "rle2")}
            for name, rows in after.items()},
        "block0": block0,
        "sorts": sorts,
        "per_block": per_block,
        "rounds_median": statistics.median(b["rounds"] for b in per_block),
        "streams": [stream_spans(data, 9, stage) for stage in ("full", "bwt")],
    }


# runs in a fresh process in either tree: only names both trees define
_TURN = r"""
import json, sys, tempfile
import torch
from tpubz_torch import stage_probe as sp
from tpubz_torch.corpus import edge_blocks, mixed_corpus
from tpubz_torch.kernels.mtf import mtf_ranks
from tpubz_torch.kernels.rle2 import rle2_encode
from tpubz_torch.kernels.suffix_sort import bwt_forward
from tpubz_torch.stream import rigprofile

mib, seed = int(sys.argv[1]), int(sys.argv[2])

def ms(fn, reps=20):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); b.synchronize()
    return a.elapsed_time(b) / reps

def device_us(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(); torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"sum_us": sum(e.time_range.end - e.time_range.start for e in dev),
            "busy_us": sp._union_us((e.time_range.start, e.time_range.end) for e in dev),
            "launches": len(dev)}

corpus = mixed_corpus(mib, seed)
data = corpus + b"".join(edge_blocks().values())
n0 = 900_000
padded = torch.zeros(900_096, dtype=torch.uint8, device="cuda")
padded[:n0] = torch.frombuffer(bytearray(corpus[:n0]), dtype=torch.uint8).to("cuda")
last = bwt_forward(padded, n0)[1]
ranks, used = mtf_ranks(last, n0)
ranks, eob = ranks.view(-1), used.sum() + 1
out = {
    "bwt_ms": ms(lambda: bwt_forward(padded, n0)),
    "bwt_device": device_us(lambda: bwt_forward(padded, n0)),
    "mtf_ms": ms(lambda: mtf_ranks(last, n0)),
    "rle2_ms": ms(lambda: rle2_encode(ranks, n0, eob)),
    "mtf_device": device_us(lambda: mtf_ranks(last, n0)),
    "rle2_device": device_us(lambda: rle2_encode(ranks, n0, eob)),
}
with tempfile.TemporaryDirectory() as cache, sp.env(TPUBZ_TORCH_CACHE=cache):
    rigprofile.reset_memo()
    out["stages"] = sp.stage_times(data, 9, "cuda")
    out["bwt_stages"] = sp.bwt_stage_times(data, 9, "cuda")
    routes = sp.route_rates(data, 9, "cuda", reps=2)
    out["profile"] = {}
    for stage in ("full", "bwt"):
        prof = sp.profile_stream(data, 9, "cuda", stage)
        out["profile"][stage] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share")}
out["routes"] = {k: [{"MBps": r["MBps"], "stage": r["stats"].get("stage"),
                      "dev_blocks": r["stats"].get("dev_blocks"),
                      "cpu_blocks": r["stats"].get("cpu_blocks")} for r in v]
                 for k, v in routes.items()}
print("TURN " + json.dumps(out))
"""


def _turn(tree: str, mib: int, seed: int) -> dict:
    env_ = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", _TURN, str(mib), str(seed)], cwd=tree,
                          env=env_, capture_output=True, text=True, timeout=900, check=True)
    line = next(s for s in proc.stdout.splitlines() if s.startswith("TURN "))
    return json.loads(line[5:])


def turns(parent: str, reps: int, mib: int, seed: int) -> list[dict]:
    """parent, this, this, parent, ``reps`` times, each a fresh process."""
    order = (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent))
    out = []
    for _ in range(reps):
        for name, tree in order:
            out.append({"tree": name, **_turn(tree, mib, seed)})
    return out


def lean_turns(data: bytes, level: int, device, reps: int = 2) -> dict:
    """MB/s of device-only full-stage streams with the int16 and the lean
    transfer form, in turns (int16, lean, lean, int16), ``reps`` times
    after one warm-up stream of each. The full stage fetches the int16
    form; a lean turn wraps ``DeviceBlockEncoder.transform`` to take the
    lean chain, which ``fetch_async`` reads off the transform's result."""
    plain = DeviceBlockEncoder.transform

    def lean_transform(self, blk, lean=False):
        return plain(self, blk, lean=True)

    def run(lean):
        DeviceBlockEncoder.transform = lean_transform if lean else plain
        return _rate(data, lambda: api.compress(data, level, device=device), device)

    rates: dict = {"int16": [], "lean": []}
    try:
        with env(**DEVICE_ONLY["full"]):
            for lean in (False, True):
                run(lean)
            for _ in range(reps):
                for lean in (False, True, True, False):
                    rates["lean" if lean else "int16"].append(run(lean)["MBps"])
    finally:
        DeviceBlockEncoder.transform = plain
    return {"MBps": rates, "median_MBps": {k: statistics.median(v) for k, v in rates.items()},
            "order": "int16, lean, lean, int16", "reps": reps}


def lean_fetch_costs(data: bytes, level: int, device) -> dict:
    """Per block, host ms of ``fetch`` of each form (the transform done and
    drained first), and of the lean form's byte stream fetched whole behind
    one event against the scalars first, then the rle2_len prefix alone."""
    from .block.encode import host_copies

    def waited(*tensors):
        host, event = host_copies(torch.device(device), *tensors)
        if event is not None:
            event.synchronize()
        return host

    enc = DeviceBlockEncoder(level, device)
    rows = []
    for blk, _ in _blocks(data, level):
        row = {}
        for name, lean in (("int16", False), ("lean", True)):
            out, _ = _timed(lambda: enc.transform(blk, lean=lean), device)
            _, row[f"fetch_{name}"] = _timed(lambda: enc.fetch(out), device)
        _, _, rl_d, _, u8, hi_pos, hc = out
        small = torch.stack((rl_d.to(torch.int64), hc.to(torch.int64)))
        _, row["whole_stream"] = _timed(lambda: waited(small, u8, hi_pos), device)

        def prefix():
            (h_small, _) = waited(small, hi_pos)
            return waited(u8[: int(h_small[0])])

        _, row["prefix_after_scalars"] = _timed(prefix, device)
        rows.append(row)
    return _summary(rows)


def devrefine_anatomy(data: bytes, level: int, device, top: int = 20) -> dict:
    """Host time of encode_block_devrefine per block of ``data`` (the
    transform done and drained first), a pass's host µs by part (copying
    its lengths up, the kernel's call, the results' copy and its wait, the
    six tree builds), and a cProfile of the same calls."""
    import cProfile
    import pstats

    enc = DeviceBlockEncoder(level, device)
    prof = cProfile.Profile()
    ms, profiled_ms = [], []
    host_us = dict.fromkeys(enc.devrefine_host_us, 0)
    for blk, crc in _blocks(data, level):
        trans, _ = _timed(lambda: enc.transform(blk), device)
        before = dict(enc.devrefine_host_us)
        _, t = _timed(lambda: enc.encode_block_devrefine(trans, crc), device)
        ms.append(t)
        for k, v in enc.devrefine_host_us.items():
            host_us[k] += v - before[k]
        prof.enable()
        _, t = _timed(lambda: enc.encode_block_devrefine(trans, crc), device)
        prof.disable()
        profiled_ms.append(t)
    passes = host_us["passes"]
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {
        "blocks": len(ms), "passes": passes,
        "ms_per_block": {"median": statistics.median(ms), "min": min(ms), "max": max(ms)},
        # a pass's host µs by part, the mean over the unprofiled passes
        "pass_host_us": {k: v / max(passes, 1) for k, v in host_us.items() if k != "passes"},
        "profiled_ms_per_block_median": statistics.median(profiled_ms),
        "top_own_time": [{"function": f"{os.path.basename(f)}:{line}({name})", "calls": nc,
                          "own_ms": tt * 1e3, "cumulative_ms": ct * 1e3}
                         for (f, line, name), (_, nc, tt, ct, _) in rows],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--out")
    ap.add_argument("--mode", choices=("all", "bwt_anatomy", "devrefine", "lean"),
                    default="all")
    ap.add_argument("--parent")
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    result = {
        "card": smi,
        "cpu_count": os.cpu_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "corpus": f"mixed_corpus({args.mib}, seed={args.seed}) + edge_blocks()",
    }
    data = mixed_corpus(args.mib, args.seed) + b"".join(edge_blocks().values())
    with tempfile.TemporaryDirectory() as cache, env(TPUBZ_TORCH_CACHE=cache):
        from .stream import rigprofile

        rigprofile.reset_memo()
        result["bytes"] = len(data)
        if args.mode in ("all", "lean"):
            result["lean"] = {"turns": lean_turns(data, 9, "cuda", max(args.reps, 2)),
                              "fetch": lean_fetch_costs(data, 9, "cuda")}
        if args.mode in ("all", "devrefine"):
            result["devrefine"] = devrefine_anatomy(data, 9, "cuda")
        if args.mode in ("all", "bwt_anatomy"):
            result["bwt_anatomy"] = bwt_anatomy(data)
        if args.mode == "all":
            result.update({
                "chain": chain_profile(args.mib, args.seed),
                "stages": stage_times(data, 9, "cuda"),
                "bwt_stages": bwt_stage_times(data, 9, "cuda"),
                "profile": [profile_stream(data, 9, "cuda", s) for s in ("full", "bwt")],
                "window": window_sweep(data, 9, "cuda"),
                "routes": route_rates(data, 9, "cuda"),
                "hybrid": hybrid_sweep(data, 9, "cuda"),
                "probation": probation_sweep(data, 9, "cuda"),
            })
        rigprofile.reset_memo()
    if args.parent:
        result["parent"] = os.path.abspath(args.parent)
        result["turns"] = turns(os.path.abspath(args.parent), args.reps, args.mib, args.seed)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

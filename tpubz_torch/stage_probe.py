"""Where a level-9 stream's time goes on the card, route by route.

    python3 -m tpubz_torch.stage_probe [--mib 16] [--seed 2026] [--out FILE]
                                       [--mode all|bwt_anatomy|devrefine]
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
  and one ``rle2_encode`` call launch on the corpus's first block, from
  ``torch.profiler``;
- ``bwt_anatomy`` (alone with ``--mode bwt_anatomy``): of one
  ``bwt_forward`` call on the corpus's first block, the device
  microseconds and launches of each kernel (``bwt_keys``,
  ``radix_pass``, ``bwt_rank_tiles``, ``bwt_rank_apply``,
  ``bwt_last_column``), per round and per radix pass, from
  ``torch.profiler``; the same for one ``radix_sort`` of the block's
  900,000 round-0 keys at each width, ``torch.sort`` of them, and one
  ``bitonic_1op``, ``bitonic_2op`` and two-pass ``stage_passes`` call at
  2^20; per block of the data the doubling rounds, the active rotations
  sorted, the call's ms and the host's microseconds in it (enqueueing
  rounds, waiting for a round's event); the host ms of the MTF and RLE2
  stages after the library call and after the plain version; and for one
  device-only stream per stage, with no profiler, the wall, the sum of each
  block's span on the card (CUDA events before its first kernel and after
  its copies are enqueued) and the share of the wall outside those spans;
- ``devrefine`` (also alone with ``--mode devrefine``): the device refine
  encoder (``DeviceBlockEncoder.encode_block_devrefine``) on every block
  of the data after its transform: host ms a block without a profiler,
  the refinement passes, and the functions with the most own time over
  all blocks under ``cProfile`` (which slows every Python call it sees:
  read the shares, not the sums);
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
from .kernels.rle2 import rle2_encode
from .kernels.suffix_sort import bwt_forward
from .native import mtf_rle2_native
from .stream import api

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = (2, 5, 28)
# the kernels of one bwt_forward call (csrc/bwt.cu, csrc/radix.cuh)
BWT_KERNELS = ("bwt_keys", "radix_pass", "bwt_rank_tiles", "bwt_rank_apply", "bwt_last_column")
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
        rle, row["rle2"] = _timed(lambda: rle2_encode(ranks, n, used.sum() + 1), device)
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


def chain_profile(mib: int, seed: int) -> dict:
    """Device µs by kernel of one mtf_ranks and one rle2_encode call on the
    BWT of the corpus's first level-9 block."""
    n = 900_000
    padded = torch.zeros(block_n(9), dtype=torch.uint8, device="cuda")
    padded[:n] = torch.frombuffer(bytearray(mixed_corpus(mib, seed)[:n]), dtype=torch.uint8).to("cuda")
    last = bwt_forward(padded, n)[1]
    ranks, used = mtf_ranks(last, n)
    eob = used.sum() + 1
    return {"mtf": kernel_device_us(lambda: mtf_ranks(last, n)),
            "rle2": kernel_device_us(lambda: rle2_encode(ranks, n, eob))}


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
        def wrap(self, *args):
            spans.append([mark(), None])
            return fn(self, *args)
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
    before = (suffix_sort.ROUNDS_RUN, suffix_sort.ACTIVE_SORTED)
    bwt_forward(padded, n)
    rounds, active = (suffix_sort.ROUNDS_RUN - before[0], suffix_sort.ACTIVE_SORTED - before[1])
    call = kernel_device_us(lambda: bwt_forward(padded, n))
    kernels = _by_kernel(call)
    passes = kernels.get("radix_pass", {"us": 0.0, "launches": 0})
    block0 = {"rounds": rounds, "active_rotations_sorted": active, "call": call,
              "by_kernel": kernels, "us_per_round": call["sum_us"] / rounds,
              "launches_per_round": call["launches"] / rounds,
              "us_per_radix_pass": passes["us"] / max(passes["launches"], 1)}
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
            _, rle2_ms = _timed(lambda: rle2_encode(ranks, blk.size, used.sum() + 1), "cuda")
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


def devrefine_anatomy(data: bytes, level: int, device, top: int = 20) -> dict:
    """Host time of encode_block_devrefine per block of ``data`` (the
    transform done and drained first), and a cProfile of the same calls."""
    import cProfile
    import pstats

    from .kernels import huffman_dev

    enc = DeviceBlockEncoder(level, device)
    prof = cProfile.Profile()
    ms, profiled_ms, passes = [], [], 0
    for blk, crc in _blocks(data, level):
        trans, _ = _timed(lambda: enc.transform(blk), device)
        before = huffman_dev.REFINE_LAUNCHES
        _, t = _timed(lambda: enc.encode_block_devrefine(trans, crc), device)
        ms.append(t)
        passes += huffman_dev.REFINE_LAUNCHES - before
        prof.enable()
        _, t = _timed(lambda: enc.encode_block_devrefine(trans, crc), device)
        prof.disable()
        profiled_ms.append(t)
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {
        "blocks": len(ms), "passes": passes,
        "ms_per_block": {"median": statistics.median(ms), "min": min(ms), "max": max(ms)},
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
    ap.add_argument("--mode", choices=("all", "bwt_anatomy", "devrefine"), default="all")
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
        if args.mode != "bwt_anatomy":
            result["devrefine"] = devrefine_anatomy(data, 9, "cuda")
        if args.mode != "devrefine":
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

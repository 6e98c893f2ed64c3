"""Where a level-9 stream's time goes on the card, route by route.

    python3 -m tpubz_torch.stage_probe [--mib 16] [--seed 2026] [--out FILE]

Needs a CUDA card: without one it exits with code 1. The functions take a
device, so the CPU tests run them at a small size. It encodes the seeded
mixed corpus plus the edge blocks (``tpubz_torch.corpus``, as
``chip_smoke.py`` does) and prints one JSON object, also written to
``--out``:

- ``stages``: milliseconds per block of each stage of the full device chain
  on the dispatcher thread (upload, BWT, MTF parts, the dominance kernel,
  RLE2, fetch), host clock with ``torch.cuda.synchronize()`` after each
  stage, and of the native emission; medians and sums over the blocks, the
  first block excluded;
- ``bwt_stages``: the same for the bwt stage: upload, BWT and ``fetch_bwt``
  on the dispatcher, then the native MTF/RLE2 and emission on the host;
- ``profile``: one device-only stream per stage under ``torch.profiler``:
  wall ms, device busy ms (the union of kernel and copy intervals), the
  idle share, the kernels with the most device time, and the device ms and
  launches of each bitonic kernel (the BWT's sorts);
- ``window``: device-only full-stage stream MB/s for each ordered-drain
  window, and of the native host engine (``compress_cpu``), in turns;
- ``routes``: stream MB/s of the device-only ``full`` and ``bwt`` stages,
  the default hybrid and ``compress_cpu``, in turns, with each stream's
  ``last_stream_stats``;
- ``hybrid``: a sweep of the CPU pool (``TPUBZ_HYBRID_CPU``: 0, a quarter,
  half, 1x, 2x and 3x the cores) by the hybrid window (``TPUBZ_WINDOW``)
  for each stage, with MB/s, ``dev_blocks`` and ``cpu_blocks``;
- ``probation``: the same for 1x the cores and window 16 by the cap on
  device blocks in flight before a stream's first device completion.
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

from .block.encode import DeviceBlockEncoder
from .corpus import edge_blocks, mixed_corpus
from .format.constants import block_budget
from .format.crc import block_crc
from .hostref.rle1 import rle1_blocks
from .kernels.mtf import mtf_parts
from .kernels.mtf_dominance import ranks_from_parts
from .kernels.rle2 import rle2_encode
from .kernels.suffix_sort import bwt_forward
from .native import mtf_rle2_native
from .stream import api

WINDOWS = (2, 5, 28)
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
        parts, row["mtf_parts"] = _timed(lambda: mtf_parts(last, n), device)
        ranks, row["dominance_kernel"] = _timed(lambda: ranks_from_parts(*parts[:4]), device)
        used = parts[4]
        rle, row["rle2"] = _timed(
            lambda: rle2_encode(ranks.view(-1), n, used.sum() + 1), device)
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
        "bitonic_kernels": [{"name": k[:120], "ms": ms, "count": c}
                            for k, (ms, c) in by_name.items() if "bitonic" in k],
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    data = mixed_corpus(args.mib, args.seed) + b"".join(edge_blocks().values())
    with tempfile.TemporaryDirectory() as cache, env(TPUBZ_TORCH_CACHE=cache):
        from .stream import rigprofile

        rigprofile.reset_memo()
        result = {
            "card": smi,
            "cpu_count": os.cpu_count(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "corpus": f"mixed_corpus({args.mib}, seed={args.seed}) + edge_blocks()",
            "bytes": len(data),
            "stages": stage_times(data, 9, "cuda"),
            "bwt_stages": bwt_stage_times(data, 9, "cuda"),
            "profile": [profile_stream(data, 9, "cuda", s) for s in ("full", "bwt")],
            "window": window_sweep(data, 9, "cuda"),
            "routes": route_rates(data, 9, "cuda"),
            "hybrid": hybrid_sweep(data, 9, "cuda"),
            "probation": probation_sweep(data, 9, "cuda"),
        }
        rigprofile.reset_memo()
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

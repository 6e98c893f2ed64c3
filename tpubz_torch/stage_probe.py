"""Where a level-9 stream's time goes on the card.

    python3 -m tpubz_torch.stage_probe [--mib 16] [--seed 2026] [--out FILE]

Needs a CUDA card: without one it exits with code 1. The functions take a
device, so the CPU tests run them at a small size. It encodes the seeded
mixed corpus plus the edge blocks (``tpubz_torch.corpus``, as
``chip_smoke.py`` does) and prints one JSON object, also written to
``--out``:

- ``stages``: milliseconds per block of each stage on the dispatcher thread
  (upload, BWT, MTF parts, the dominance kernel, RLE2, fetch), host clock
  with ``torch.cuda.synchronize()`` after each stage, and of the native
  emission; medians and sums over the blocks, the first block excluded;
- ``profile``: one ``compress`` under ``torch.profiler``: wall ms, device
  busy ms (the union of kernel and copy intervals), the idle share, the
  kernels with the most device time, and the device ms and launches of
  each bitonic kernel (the BWT's sorts);
- ``window``: stream MB/s for each ordered-drain window, and of tpubz's
  native host engine (``compress_cpu``) on the same data, in turns.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpubz.format.constants import block_budget
from tpubz.format.crc import block_crc
from tpubz.hostref.rle1 import rle1_blocks

from .block.encode import DeviceBlockEncoder
from .corpus import edge_blocks, mixed_corpus
from .kernels.mtf import mtf_parts
from .kernels.mtf_dominance import ranks_from_parts
from .kernels.rle2 import rle2_encode
from .kernels.suffix_sort import bwt_forward
from .stream import api

WINDOWS = (2, 5, 28)


def _timed(fn, device):
    """(result, host ms) of fn, with the device drained before and after."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def stage_times(data: bytes, level: int, device) -> dict:
    enc = DeviceBlockEncoder(level, device)
    arr = np.frombuffer(data, np.uint8)
    out, blocks = rle1_blocks(arr, block_budget(level))
    rows = []
    for o0, o1, i0, i1 in blocks:
        blk, n = out[o0:o1], o1 - o0
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
        crc = block_crc(arr[i0:i1])
        t0 = time.perf_counter()
        enc.emit_block(*fetched, crc)
        row["native_emit"] = (time.perf_counter() - t0) * 1e3
        rows.append(row)
    rows = rows[1:]  # the first block warms the allocator and the sorts
    return {
        "blocks_timed": len(rows),
        "median_ms": {k: statistics.median(r[k] for r in rows) for k in rows[0]},
        "sum_ms": {k: sum(r[k] for r in rows) for k in rows[0]},
    }


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_stream(data: bytes, level: int, device) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
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
        "wall_ms": wall,
        "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall if dev else None,
        "device_events": len(dev),
        "top_kernels": [{"name": k[:120], "ms": ms, "count": c} for k, (ms, c) in top],
        "bitonic_kernels": [{"name": k[:120], "ms": ms, "count": c}
                            for k, (ms, c) in by_name.items() if "bitonic" in k],
    }


def window_sweep(data: bytes, level: int, device, reps: int = 3) -> dict:
    """Stream MB/s per ordered-drain window, and of tpubz's native host
    engine on the same machine's cores (JAX-free), taken in turns."""
    from tpubz.stream.api import compress_cpu

    rates: dict = {w: [] for w in WINDOWS}
    host = []
    saved = api.WINDOW
    try:
        for _ in range(reps):
            for w in WINDOWS:
                api.WINDOW = w
                _, ms = _timed(lambda: api.compress(data, level, device=device), device)
                rates[w].append(len(data) / 1e3 / ms)
            t0 = time.perf_counter()
            compress_cpu(data, level)
            host.append(len(data) / 1e6 / (time.perf_counter() - t0))
    finally:
        api.WINDOW = saved
    return {"default": saved, "MBps": {str(w): r for w, r in rates.items()},
            "host_engine_MBps": host}


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
    result = {
        "card": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "corpus": f"mixed_corpus({args.mib}, seed={args.seed}) + edge_blocks()",
        "bytes": len(data),
        "stages": stage_times(data, 9, "cuda"),
        "profile": profile_stream(data, 9, "cuda"),
        "window": window_sweep(data, 9, "cuda"),
    }
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

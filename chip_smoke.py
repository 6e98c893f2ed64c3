#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpubz_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
builds the CUDA kernels from tpubz_torch/csrc, holds each against its plain
PyTorch version at the level-9 shapes (tolerance 0: the codec is integer),
checks a short level-9 stream on the card byte for byte against the port's
plain path on the CPU, then drives level-9 multi-block encode through
tpubz_torch.compress on a seeded corpus of at least 16 MiB and round-trips
it through tpubz_torch.decompress and, where it is installed, bunzip2. Every
phase prints one line; any failure raises, so the script exits non-zero
without the final line. Without a CUDA device it exits with code 1 and
prints no result.

The line before the last is {"kernels": [...]}: per kernel its launches in
the main-path run, its largest difference from the plain version, and both
times from CUDA events. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import hashlib
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

LEVEL = 9
CORPUS_MIB = 16
SEED = 2026
SHORT_MIB = 3  # corpus prefix of the stream checked against the CPU path


def _say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _cuda_ms(fn, reps):
    """Mean device milliseconds per call, from CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import tpubz_torch
    from tpubz_torch.block.encode import block_n
    from tpubz_torch.corpus import edge_blocks, mixed_corpus
    from tpubz_torch.kernels import _build, mtf_dominance
    from tpubz_torch.kernels.mtf import mtf_parts
    from tpubz_torch.kernels.suffix_sort import bwt_forward

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load()
    _say("device", f"device={kind!r} count={torch.cuda.device_count()} torch={torch.__version__} "
            f"cuda={torch.version.cuda} kernel_build_s={time.perf_counter() - t0}")

    corpus = mixed_corpus(CORPUS_MIB, SEED)
    edges = edge_blocks()
    data = corpus + b"".join(edges.values())
    _say("corpus", f"corpus=mixed_corpus({CORPUS_MIB}, seed={SEED}) corpus_bytes={len(corpus)} "
            f"corpus_sha256={hashlib.sha256(corpus).hexdigest()} with_edges_bytes={len(data)} "
            f"with_edges_sha256={hashlib.sha256(data).hexdigest()}")

    # the kernel against its plain version at the level-9 shape, exactly:
    # seeded random parts, and the real parts of the corpus's first block
    N = block_n(LEVEL)
    nc = N // mtf_dominance.CHUNK
    rng = np.random.default_rng(SEED)
    rand = [
        torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
            rng.integers(-1, 256, (nc, 256)),
            rng.integers(0, 257, (nc, 256)),
            rng.integers(0, 2 * N + 256, (nc, 256)),
            rng.integers(0, 2 * N + 256, (nc, 256)),
        )
    ]
    n0 = LEVEL * 100_000
    padded = torch.zeros(N, dtype=torch.uint8, device=dev)
    padded[:n0] = torch.frombuffer(bytearray(corpus[:n0]), dtype=torch.uint8).to(dev)
    _, last0 = bwt_forward(padded, n0)
    real_parts = list(mtf_parts(last0, n0)[:4])
    max_err = 0
    for name, parts in (("random", rand), ("corpus_block0", real_parts)):
        got = mtf_dominance.ranks_from_parts(*parts)
        ref = mtf_dominance.ranks_from_parts_ref(*parts)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum())
        err = int((got - ref).abs().max())
        max_err = max(max_err, err)
        _say("kernel", f"mtf_dominance vs plain inputs={name} nc={nc} mismatches={mismatches} "
                f"max_abs_err={err} tolerance=0")
        if mismatches:
            raise AssertionError(f"mtf_dominance disagrees with its plain version on {name}")
    kernel_ms = _cuda_ms(lambda: mtf_dominance.ranks_from_parts(*real_parts), 50)
    plain_ms = _cuda_ms(lambda: mtf_dominance.ranks_from_parts_ref(*real_parts), 5)
    _say("kernel", f"mtf_dominance nc={nc} kernel_ms={kernel_ms} plain_ms={plain_ms} "
            f"(CUDA events, inputs=corpus_block0)")

    # a short stream on the card against the port's plain path on the CPU:
    # equal bytes mean every block's transforms agree
    short = corpus[: SHORT_MIB << 20] + b"".join(edges.values())
    got = tpubz_torch.compress(short, LEVEL, device="cuda")
    short_blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
    t1 = time.perf_counter()
    ref = tpubz_torch.compress(short, LEVEL, device="cpu")
    cpu_dt = time.perf_counter() - t1
    if got != ref:
        raise AssertionError("the stream on the card differs from the plain CPU path")
    _say("short", f"bytes={len(short)} blocks={short_blocks} cuda_stream==cpu_plain_stream "
            f"cpu_plain_seconds={cpu_dt}")

    # the main path, counted from zero
    mtf_dominance.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = tpubz_torch.compress(data, LEVEL, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = mtf_dominance.LAUNCHES
    blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
    if tpubz_torch.decompress(stream) != data:
        raise AssertionError("tpubz_torch.decompress round trip failed")
    ran = ["tpubz_torch.decompress"]
    if shutil.which("bunzip2"):
        out = subprocess.run(["bunzip2", "-c"], input=stream, capture_output=True,
                             timeout=300, check=True).stdout
        if out != data:
            raise AssertionError("bunzip2 round trip failed")
        ran.append("bunzip2")
    _say("stream", f"stream_bytes={len(stream)} ratio={len(stream) / len(data)} "
            f"round_trips={'+'.join(ran)}")

    # the main path went through the kernel, without jax
    if launches < blocks:
        raise AssertionError(f"{launches} kernel launches for {blocks} blocks")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    mb = len(data) / 1e6
    _say("path", f"blocks={blocks} mtf_dominance_launches={launches} MB={mb} seconds={dt} "
            f"MBps={mb / dt} jax_imported=False")

    print(json.dumps({"kernels": [{
        "name": "mtf_dominance",
        "route": "cuda",
        "source": "tpubz_torch/csrc/mtf_dominance.cu",
        "replaces": "tpubz/kernels/mtf_pallas.py:46",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

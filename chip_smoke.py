#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpubz_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
builds the CUDA kernels from tpubz_torch/csrc, holds each against its plain
PyTorch version at the level-9 shapes (tolerance 0: the codec is integer),
checks the BWT on the card against the port's plain path on the CPU for
real and edge blocks, and a short level-9 stream byte for byte, then drives
level-9 multi-block encode through
tpubz_torch.compress on a seeded corpus of at least 16 MiB and round-trips
it through tpubz_torch.decompress and, where it is installed, bunzip2. That
run ([path]) is device-only on the full stage (TPUBZ_HYBRID_CPU=0,
TPUBZ_DEVICE_STAGE=full). The same data then goes through the bwt stage
([stage_bwt], device-only) and the default hybrid routing with a fresh rig
profile ([hybrid], beside compress_cpu), each byte-equal to [path]'s stream
with its kernel counts read from zero; and the short stream through
compress_file, open("wb"), BZ2Compressor and python -m tpubz_torch
([files]), each byte-equal to tpubz_torch.compress. Every phase prints one
line; any failure raises, so the script exits non-zero without the final
line. Without a CUDA device it exits with code 1 and prints no result.

The line before the last is {"kernels": [...]}: per kernel its launches in
the main-path run, its largest difference from the plain version, and both
times from CUDA events. The bitonic sorts' launches are calls of their
wrappers; stage_passes' are the launches of the two pass kernels
(bitonic_global_pass, bitonic_tile) that it shares with the sorts, counted
where the sorts launch them. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

LEVEL = 9
CORPUS_MIB = 16
SEED = 2026
SHORT_MIB = 3  # corpus prefix of the stream checked against the CPU path


def _say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _zero_counts():
    from tpubz_torch.kernels import bitonic, mtf_dominance

    mtf_dominance.LAUNCHES = 0
    bitonic.LAUNCHES = bitonic.PASS_LAUNCHES = 0
    bitonic.CALLS.update(dict.fromkeys(bitonic.CALLS, 0))


def _bunzip2_ok(stream, data):
    """True when bunzip2 is installed and gives data back; raises when it
    gives anything else."""
    if not shutil.which("bunzip2"):
        return False
    out = subprocess.run(["bunzip2", "-c"], input=stream, capture_output=True,
                         timeout=300, check=True).stdout
    if out != data:
        raise AssertionError("bunzip2 round trip failed")
    return True


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
    from tpubz_torch.stage_probe import env

    with tempfile.TemporaryDirectory() as tmp, env(TPUBZ_TORCH_CACHE=os.path.join(tmp, "cache")):
        return _smoke(tmp)


def _smoke(tmp):
    import tpubz_torch
    from tpubz_torch.block.encode import block_n
    from tpubz_torch.corpus import edge_blocks, mixed_corpus
    from tpubz_torch.kernels import _build, bitonic, mtf_dominance, suffix_sort
    from tpubz_torch.kernels.mtf import mtf_parts
    from tpubz_torch.kernels.suffix_sort import bwt_forward
    from tpubz_torch.stage_probe import DEVICE_ONLY, env

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

    # the bitonic kernels against their plain versions at 2^20, exactly:
    # int32 keys in [0, 50), whose duplicates move payloads by the tie rule;
    # the int64 keys of block 0's first doubling round (the main path's
    # sorts); the TPU probe's stage cases
    L = 1 << bitonic.MAX_LOG2
    k32 = torch.from_numpy(rng.integers(0, 50, L).astype(np.int32)).to(dev)
    p32 = torch.from_numpy(rng.permutation(L).astype(np.int32)).to(dev)
    r32 = torch.from_numpy(rng.integers(0, 1 << 30, L).astype(np.int32)).to(dev)
    k64 = suffix_sort.round_keys(suffix_sort.seed_rank(padded[:n0]), 3)
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    # the TPU probe's cases (probe_pallas_pass.py:124-129): passes at row
    # distances (>= 2^10 there; global passes here, >= the 2^11 tile) and at
    # lane distances (tile passes here)
    stages = {"row2": [19, 18], "row8": list(range(19, 11, -1)),
              "lane2": [9, 8], "lane8": list(range(9, 1, -1))}
    checks = [
        ("bitonic_1op", "i32_dup", lambda: bitonic.bitonic_1op(k32),
         lambda: bitonic.bitonic_1op_ref(k32)),
        ("bitonic_2op", "i32_dup", lambda: bitonic.bitonic_2op(k32, p32),
         lambda: bitonic.bitonic_2op_ref(k32, p32)),
        ("bitonic_1op", "i64_round_block0", lambda: bitonic.bitonic_1op(k64),
         lambda: bitonic.bitonic_1op_ref(k64)),
        ("bitonic_2op", "i64_round_block0", lambda: bitonic.bitonic_2op(k64, pos),
         lambda: bitonic.bitonic_2op_ref(k64, pos)),
    ] + [
        ("stage_passes", f"i32_{case}", lambda js=js: bitonic.stage_passes(r32.clone(), js),
         lambda js=js: bitonic.stage_passes_ref(r32.clone(), js))
        for case, js in stages.items()
    ]
    sort_err = {"bitonic_1op": 0, "bitonic_2op": 0, "stage_passes": 0}
    for name, inputs, run, plain in checks:
        got, ref = run(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        mismatches = sum(int((g != r).sum()) for g, r in zip(got, ref))
        err = max(int((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
        sort_err[name] = max(sort_err[name], err)
        _say("kernel", f"{name} vs plain inputs={inputs} n={L} mismatches={mismatches} "
                f"max_abs_err={err} tolerance=0")
        if mismatches:
            raise AssertionError(f"{name} disagrees with its plain version on {inputs}")
    # kernel and plain ms at the main path's shape, and the library radix
    # sort's (which always returns indices too) beside them
    lib_ms = _cuda_ms(lambda: torch.sort(k64), 20)
    sort_ms = {
        "bitonic_1op": (_cuda_ms(lambda: bitonic.bitonic_1op(k64), 20),
                        _cuda_ms(lambda: bitonic.bitonic_1op_ref(k64), 3)),
        "bitonic_2op": (_cuda_ms(lambda: bitonic.bitonic_2op(k64, pos), 20),
                        _cuda_ms(lambda: bitonic.bitonic_2op_ref(k64, pos), 3)),
    }
    for name, (ms, plain) in sort_ms.items():
        _say("kernel", f"{name} n={L} keys=int64 kernel_ms={ms} plain_ms={plain} "
                f"torch_sort_ms={lib_ms} (CUDA events, inputs=i64_round_block0)")
    i32_ms = (_cuda_ms(lambda: bitonic.bitonic_2op(k32, p32), 20),
              _cuda_ms(lambda: bitonic.bitonic_2op_ref(k32, p32), 3),
              _cuda_ms(lambda: torch.sort(k32), 20))
    _say("kernel", f"bitonic_2op n={L} keys=int32 kernel_ms={i32_ms[0]} plain_ms={i32_ms[1]} "
            f"torch_sort_ms={i32_ms[2]} (CUDA events, inputs=i32_dup)")
    stage_ms = {}
    for case, js in stages.items():
        ms = _cuda_ms(lambda: bitonic.stage_passes(r32, js), 50)
        plain = _cuda_ms(lambda: bitonic.stage_passes_ref(r32.clone(), js), 5)
        stage_ms[case] = (ms, plain)
        _say("kernel", f"stage_passes {case} js={js} n={L} keys=int32 kernel_ms={ms} "
                f"plain_ms={plain} us_per_pass={ms * 1e3 / len(js)} (CUDA events, one call "
                f"of {'global passes' if case.startswith('row') else 'one tile launch'}, "
                f"host launch included)")

    # the BWT on the card against the port's plain path on the CPU, for
    # block 0 of the corpus and each edge block
    for name, blk in [("corpus_block0", corpus[:n0])] + list(edges.items()):
        host = torch.zeros(N, dtype=torch.uint8)
        host[: len(blk)] = torch.frombuffer(bytearray(blk), dtype=torch.uint8)
        t1 = time.perf_counter()
        key, last = bwt_forward(host.to(dev), len(blk))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        ckey, clast = bwt_forward(host, len(blk))
        cpu_s = time.perf_counter() - t1
        if int(key) != int(ckey) or not torch.equal(last.cpu(), clast):
            raise AssertionError(f"bwt_forward on the card differs from the CPU path on {name}")
        _say("bwt", f"block={name} n={len(blk)} key={int(key)} card==cpu_plain "
                f"card_seconds={card_s} cpu_plain_seconds={cpu_s}")

    # a short stream on the card against the port's plain path on the CPU:
    # equal bytes mean every block's transforms agree
    short = corpus[: SHORT_MIB << 20] + b"".join(edges.values())
    with env(**DEVICE_ONLY["full"]):
        got = tpubz_torch.compress(short, LEVEL, device="cuda")
        short_blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
        t1 = time.perf_counter()
        ref = tpubz_torch.compress(short, LEVEL, device="cpu")
        cpu_dt = time.perf_counter() - t1
    if got != ref:
        raise AssertionError("the stream on the card differs from the plain CPU path")
    _say("short", f"bytes={len(short)} blocks={short_blocks} cuda_stream==cpu_plain_stream "
            f"cpu_plain_seconds={cpu_dt}")

    # the main path, device-only on the full stage, counted from zero
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with env(**DEVICE_ONLY["full"]):
        stream = tpubz_torch.compress(data, LEVEL, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = mtf_dominance.LAUNCHES
    sort_launches, sort_calls = bitonic.LAUNCHES, dict(bitonic.CALLS)
    pass_launches = bitonic.PASS_LAUNCHES
    blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
    if tpubz_torch.decompress(stream) != data:
        raise AssertionError("tpubz_torch.decompress round trip failed")
    ran = ["tpubz_torch.decompress"] + ["bunzip2"] * _bunzip2_ok(stream, data)
    _say("stream", f"stream_bytes={len(stream)} ratio={len(stream) / len(data)} "
            f"round_trips={'+'.join(ran)}")

    # the main path went through the kernels, without jax: every block ran
    # at least one doubling round (2op) and its last-column sort (1op)
    if launches < blocks:
        raise AssertionError(f"{launches} kernel launches for {blocks} blocks")
    if sort_launches < 2 * blocks or min(sort_calls["bitonic_1op"], sort_calls["bitonic_2op"]) < blocks:
        raise AssertionError(f"bitonic calls {sort_calls} for {blocks} blocks")
    if pass_launches < sort_launches:
        raise AssertionError(f"{pass_launches} pass-kernel launches for {sort_launches} sorts")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    mb = len(data) / 1e6
    _say("path", f"blocks={blocks} mtf_dominance_launches={launches} "
            f"bitonic_launches={sort_launches} bitonic_calls={sort_calls} "
            f"pass_kernel_launches={pass_launches} MB={mb} seconds={dt} "
            f"MBps={mb / dt} jax_imported=False")

    stage_bwt(tpubz_torch, data, stream)
    hybrid(tpubz_torch, data, stream, tmp)
    files(tpubz_torch, short, got, tmp)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    sorts = [
        ("bitonic_1op", "tools/probe_pallas_sort.py:110", sort_calls["bitonic_1op"],
         sort_ms["bitonic_1op"]),
        ("bitonic_2op", "tools/probe_pallas_sort.py:121", sort_calls["bitonic_2op"],
         sort_ms["bitonic_2op"]),
        ("stage_passes", "tools/probe_pallas_pass.py:83", pass_launches, stage_ms["row2"]),
    ]
    print(json.dumps({"kernels": [{
        "name": "mtf_dominance",
        "route": "cuda",
        "source": "tpubz_torch/csrc/mtf_dominance.cu",
        "replaces": "tpubz/kernels/mtf_pallas.py:46",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "tpubz_torch/csrc/bitonic.cu",
        "replaces": replaces,
        "launches": n,
        "max_abs_err": sort_err[name],
        "ms": times[0],
        "plain_ms": times[1],
    } for name, replaces, n, times in sorts]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def stage_bwt(tpubz_torch, data, stream):
    """The bwt stage, device-only, on the main path's data: the same bytes,
    the bitonic sorts on every block and no MTF kernel (it lies off this
    stage)."""
    from tpubz_torch.kernels import bitonic, mtf_dominance
    from tpubz_torch.stage_probe import DEVICE_ONLY, env

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with env(**DEVICE_ONLY["bwt"]):
        got = tpubz_torch.compress(data, LEVEL, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = dict(tpubz_torch.stream.api.last_stream_stats)
    calls = dict(bitonic.CALLS)
    if got != stream:
        raise AssertionError("the bwt stage's stream differs from the full stage's")
    if st["stage"] != "bwt" or st["dev_blocks"] != st["blocks"]:
        raise AssertionError(f"not a device-only bwt stream: {st}")
    if sum(calls.values()) < 2 * st["blocks"] or calls["bitonic_1op"] < st["blocks"]:
        raise AssertionError(f"bitonic calls {calls} for {st['blocks']} blocks")
    if mtf_dominance.LAUNCHES:
        raise AssertionError(f"{mtf_dominance.LAUNCHES} mtf_dominance launches on the bwt stage")
    mb = len(data) / 1e6
    _say("stage_bwt", f"blocks={st['blocks']} stream==path_stream bitonic_calls={calls} "
         f"bitonic_launches={bitonic.LAUNCHES} pass_kernel_launches={bitonic.PASS_LAUNCHES} "
         f"mtf_dominance_launches=0 MB={mb} seconds={dt} MBps={mb / dt}")


def hybrid(tpubz_torch, data, stream, tmp):
    """The default routing (hybrid CPU pool, stage from a fresh profile) on
    the main path's data, then compress_cpu on the same data."""
    from tpubz_torch.kernels import bitonic, mtf_dominance
    from tpubz_torch.stage_probe import env
    from tpubz_torch.stream import rigprofile

    rigprofile.reset_memo()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with env(TPUBZ_TORCH_CACHE=os.path.join(tmp, "hybrid_cache"), TPUBZ_HYBRID_CPU=None,
             TPUBZ_DEVICE_STAGE=None):
        got = tpubz_torch.compress(data, LEVEL, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = dict(tpubz_torch.stream.api.last_stream_stats)
        rigprofile.reset_memo()
    if got != stream:
        raise AssertionError("the hybrid stream differs from the device-only stream")
    if st["engine"] != "hybrid" or st["dev_blocks"] < 1:
        raise AssertionError(f"the hybrid ran no device block: {st}")
    t0 = time.perf_counter()
    host = tpubz_torch.compress_cpu(data, LEVEL)
    cpu_dt = time.perf_counter() - t0
    if host != stream:
        raise AssertionError("compress_cpu differs from the device-only stream")
    mb = len(data) / 1e6
    _say("hybrid", f"blocks={st['blocks']} stage={st['stage']} dev_blocks={st['dev_blocks']} "
         f"cpu_blocks={st['cpu_blocks']} cpu_workers={st['cpu_workers']} window={st['window']} "
         f"stream==path_stream bitonic_calls={dict(bitonic.CALLS)} "
         f"mtf_dominance_launches={mtf_dominance.LAUNCHES} MB={mb} seconds={dt} "
         f"MBps={mb / dt} compress_cpu_seconds={cpu_dt} compress_cpu_MBps={mb / cpu_dt} "
         f"cpu_count={os.cpu_count()}")


def files(tpubz_torch, short, want, tmp):
    """The file surfaces on the card, each byte-equal to compress on the
    short stream and read back by bunzip2."""
    from tpubz_torch.stream.files import compress_file

    src = os.path.join(tmp, "short.bin")
    with open(src, "wb") as f:
        f.write(short)
    outs = {}
    compress_file(src, os.path.join(tmp, "file.bz2"), LEVEL, device="cuda")
    with open(os.path.join(tmp, "file.bz2"), "rb") as f:
        outs["compress_file"] = f.read()
    with tpubz_torch.open(os.path.join(tmp, "open.bz2"), "wb", device="cuda") as f:
        f.write(short)
    with open(os.path.join(tmp, "open.bz2"), "rb") as f:
        outs["open_wb"] = f.read()
    comp = tpubz_torch.BZ2Compressor(LEVEL, device="cuda")
    chunks = [comp.compress(short[i:i + (1 << 20)]) for i in range(0, len(short), 1 << 20)]
    outs["BZ2Compressor"] = b"".join(chunks) + comp.flush()
    root = os.path.dirname(os.path.abspath(__file__))
    subprocess.run([sys.executable, "-m", "tpubz_torch", "-k", "-9", src], cwd=root,
                   env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                       filter(None, (root, os.environ.get("PYTHONPATH"))))),
                   check=True, timeout=600)
    with open(src + ".bz2", "rb") as f:
        outs["python -m tpubz_torch"] = f.read()
    checked = []
    for name, out in outs.items():
        if out != want:
            raise AssertionError(f"{name} differs from tpubz_torch.compress")
        checked.append(name + ("+bunzip2" if _bunzip2_ok(out, short) else ""))
    _say("files", f"bytes={len(short)} equal_to_compress={','.join(checked)}")


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpubz_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and g++.
It builds the port's native host engine (tpubz_torch/native, g++) and the
CUDA kernels (tpubz_torch/csrc, nvcc) into tpubz_torch/_build, holds each
kernel against its plain
PyTorch version at the level-9 shapes (tolerance 0: the codec is integer;
MTF and RLE2 on the corpus's first block and the three edge blocks, RLE2
also on random ranks with long zero runs; the BWT's library call, key and
every lane of the last column, on the same four blocks),
checks the BWT on the card against the port's plain path on the CPU for
real and edge blocks, and a short level-9 stream byte for byte, then drives
level-9 multi-block encode through
tpubz_torch.compress on a seeded corpus of at least 16 MiB and round-trips
it through tpubz_torch.decompress and, where it is installed, bunzip2. That
run ([path]) is device-only on the full stage (TPUBZ_HYBRID_CPU=0,
TPUBZ_DEVICE_STAGE=full); its data ends in a periodic tail cut so that the
last block is a whole number of periods, a block with tied rotations, as a
file that ends in padding gives. The same data then goes through the bwt stage
([stage_bwt], device-only) and the default hybrid routing with a fresh rig
profile ([hybrid], beside compress_cpu), each byte-equal to [path]'s stream
with its kernel counts read from zero; and the short stream through
compress_file, open("wb"), BZ2Compressor and python -m tpubz_torch
([files]), each byte-equal to tpubz_torch.compress. Every phase prints one
line; any failure raises, so the script exits non-zero without the final
line. Without a CUDA device it exits with code 1 and prints no result.

The line before the last is {"kernels": [...]}: per kernel its launches in
the main-path run, its largest difference from the plain version, its time,
the plain version's and the one-call PyTorch equivalent's where one exists
(torch.sort for the sorts), all from CUDA events, and its bound: the larger
of the bytes it must move over 3.35 TB/s and its integer operations over
the int32 rate of the card's CUDA cores (132 SMs x 64 lanes x 1.98 GHz,
16.7 T/s; the data sheet's 67 TFLOP/s is the float32 rate: twice the
lanes, and an FMA counted as two). The MTF and RLE2 launches are calls of their wrappers (three
kernels each); the BWT's are calls of its wrapper (one library call a
block: three kernels and a sort per doubling round, then the last column);
the bitonic sorts' launches are the sorts run on the card, which on the
main path are the BWT call's (a 2op sort per round, a 1op sort per block
with ties);
stage_passes' are the launches of the two pass kernels
(bitonic_global, bitonic_tile) that it shares with the sorts, counted where
the sorts launch them. The port imports neither tpubz nor jax, and the run
checks that neither was loaded. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import hashlib
import json
import math
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
# the card's peaks (H100 SXM, at 700 W): HBM bytes/s (data sheet), and the
# CUDA cores' int32 rate: 132 SMs x 64 integer lanes x 1.98 GHz (the 67
# TFLOP/s float32 rate has twice the lanes and counts an FMA as two)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _zero_counts():
    from tpubz_torch.kernels import bitonic, mtf, rle2, suffix_sort

    mtf.LAUNCHES = rle2.LAUNCHES = 0
    suffix_sort.LAUNCHES = suffix_sort.ROUNDS_RUN = suffix_sort.KERNEL_LAUNCHES = 0
    bitonic.LAUNCHES = bitonic.PASS_LAUNCHES = 0
    bitonic.CALLS.update(dict.fromkeys(bitonic.CALLS, 0))


def _bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time for nbytes moved once
    and ops int32 operations, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _no_reference_modules():
    """Raise if a module of tpubz or of jax was loaded."""
    loaded = [m for m in sys.modules if m.split(".")[0] in ("tpubz", "jax")]
    if loaded:
        raise AssertionError(f"the port loaded {loaded[:5]}")


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


def _with_tied_tail(data):
    """data plus a tail of all 256 byte values in order, cut so that the
    stream's last level-9 block lies inside the tail and is a whole number
    of its periods: every rotation of that block has 3,000-odd equals."""
    from tpubz_torch.format.constants import block_budget
    from tpubz_torch.hostref.rle1 import rle1_blocks

    period = bytes(range(256))
    reps = 4000  # more than one block: the last block starts inside the tail
    while True:
        out = data + period * reps
        _, blocks = rle1_blocks(np.frombuffer(out, np.uint8), block_budget(LEVEL))
        o0, o1, i0, _ = blocks[-1]
        whole = (o1 - o0) // 256 * 256  # the tail has no runs: RLE1 leaves it as it is
        if whole and i0 >= len(data):
            return out[: len(out) - ((o1 - o0) - whole)]
        reps += 2


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
    from tpubz_torch import native
    from tpubz_torch.kernels import _build, bitonic, mtf, rle2, suffix_sort
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
    native.get_lib()
    t1 = time.perf_counter()
    _build.load()
    _say("device", f"device={kind!r} count={torch.cuda.device_count()} torch={torch.__version__} "
            f"cuda={torch.version.cuda} native_build_s={t1 - t0} "
            f"kernel_build_s={time.perf_counter() - t1} libraries={native.LIB_PATH},"
            f"{_build.LIB_PATH}")

    corpus = mixed_corpus(CORPUS_MIB, SEED)
    edges = edge_blocks()
    data = _with_tied_tail(corpus + b"".join(edges.values()))
    _say("corpus", f"corpus=mixed_corpus({CORPUS_MIB}, seed={SEED}) corpus_bytes={len(corpus)} "
            f"corpus_sha256={hashlib.sha256(corpus).hexdigest()} "
            f"with_edges_and_tied_tail_bytes={len(data)} "
            f"with_edges_and_tied_tail_sha256={hashlib.sha256(data).hexdigest()}")

    N = block_n(LEVEL)
    n0 = LEVEL * 100_000
    padded = torch.zeros(N, dtype=torch.uint8, device=dev)
    padded[:n0] = torch.frombuffer(bytearray(corpus[:n0]), dtype=torch.uint8).to(dev)
    rng = np.random.default_rng(SEED)
    chain = chain_kernels(padded, n0, edges, rng)
    chain["bwt"] = bwt_kernels(padded, n0, edges)

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
    # kernel and plain ms at the main path's shape, torch.sort's (a radix
    # sort that always returns indices too) beside them, the kernel
    # launches of one call, and the bound: each input read and each output
    # written once, against 210 * n / 2 comparisons
    def launches_of(run):
        before = bitonic.PASS_LAUNCHES
        run()
        torch.cuda.synchronize()
        return bitonic.PASS_LAUNCHES - before

    compares = len(bitonic.network(bitonic.MAX_LOG2)) * L // 2
    sort_cases = {
        "bitonic_1op": ("int64", lambda: bitonic.bitonic_1op(k64),
                        lambda: bitonic.bitonic_1op_ref(k64), lambda: torch.sort(k64),
                        _bound(2 * L * 8, compares)),
        "bitonic_2op": ("int64", lambda: bitonic.bitonic_2op(k64, pos),
                        lambda: bitonic.bitonic_2op_ref(k64, pos), lambda: torch.sort(k64),
                        _bound(2 * L * 12, compares)),
        "bitonic_2op_i32": ("int32", lambda: bitonic.bitonic_2op(k32, p32),
                            lambda: bitonic.bitonic_2op_ref(k32, p32), lambda: torch.sort(k32),
                            _bound(2 * L * 8, compares)),
    }
    sort_ms = {}
    for name, (keys, run, plain, lib, bound) in sort_cases.items():
        sort_ms[name] = (_cuda_ms(run, 20), _cuda_ms(plain, 3), _cuda_ms(lib, 20), bound)
        ms, plain_t, lib_t, _ = sort_ms[name]
        _say("kernel", f"{name.removesuffix('_i32')} n={L} keys={keys} kernel_ms={ms} "
                f"plain_ms={plain_t} torch_sort_ms={lib_t} "
                f"pass_launches_per_call={launches_of(run)} bound_us={bound[0] * 1e3} "
                f"bound_by={bound[1]} (CUDA events, "
                f"inputs={'i64_round_block0' if keys == 'int64' else 'i32_dup'})")
    stage_ms = {}
    for case, js in stages.items():
        ms = _cuda_ms(lambda: bitonic.stage_passes(r32, js), 50)
        plain = _cuda_ms(lambda: bitonic.stage_passes_ref(r32.clone(), js), 5)
        bound = _bound(2 * L * 4, len(js) * L // 2)
        stage_ms[case] = (ms, plain, None, bound)
        _say("kernel", f"stage_passes {case} js={js} n={L} keys=int32 kernel_ms={ms} "
                f"plain_ms={plain} us_per_pass={ms * 1e3 / len(js)} "
                f"pass_launches_per_call={launches_of(lambda: bitonic.stage_passes(r32, js))} "
                f"bound_us={bound[0] * 1e3} bound_by={bound[1]} (CUDA events, one call, "
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
    launches = {"mtf": mtf.LAUNCHES, "rle2": rle2.LAUNCHES, "bwt": suffix_sort.LAUNCHES}
    rounds, bwt_kernel_launches = suffix_sort.ROUNDS_RUN, suffix_sort.KERNEL_LAUNCHES
    sort_calls = dict(bitonic.CALLS)
    pass_launches = bitonic.PASS_LAUNCHES
    blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
    if tpubz_torch.decompress(stream) != data:
        raise AssertionError("tpubz_torch.decompress round trip failed")
    ran = ["tpubz_torch.decompress"] + ["bunzip2"] * _bunzip2_ok(stream, data)
    _say("stream", f"stream_bytes={len(stream)} ratio={len(stream) / len(data)} "
            f"round_trips={'+'.join(ran)}")

    # the main path went through the kernels, without jax: every block ran
    # the BWT's library call, its MTF and its RLE2; the call ran a 2op sort
    # per doubling round (at least one a block), a 1op sort only for a
    # block with tied rotations (the last one), and every sort its passes
    if min(launches.values()) < blocks:
        raise AssertionError(f"BWT, MTF and RLE2 launches {launches} for {blocks} blocks")
    if sort_calls["bitonic_2op"] != rounds or rounds < blocks or not (
            1 <= sort_calls["bitonic_1op"] < blocks):
        raise AssertionError(f"bitonic sorts {sort_calls}, {rounds} rounds for {blocks} blocks")
    sorts_run = sort_calls["bitonic_1op"] + sort_calls["bitonic_2op"]
    if pass_launches < sorts_run or bwt_kernel_launches < 3 * rounds + blocks:
        raise AssertionError(f"{pass_launches} pass-kernel and {bwt_kernel_launches} BWT-kernel "
                             f"launches for {sorts_run} sorts in {rounds} rounds")
    _no_reference_modules()
    mb = len(data) / 1e6
    _say("path", f"blocks={blocks} bwt_launches={launches['bwt']} bwt_rounds={rounds} "
            f"bwt_kernel_launches={bwt_kernel_launches} mtf_launches={launches['mtf']} "
            f"rle2_launches={launches['rle2']} "
            f"bitonic_wrapper_calls={bitonic.LAUNCHES} bitonic_sorts={sort_calls} "
            f"pass_kernel_launches={pass_launches} MB={mb} seconds={dt} "
            f"MBps={mb / dt} tpubz_imported=False jax_imported=False")

    stage_bwt(tpubz_torch, data, stream)
    hybrid(tpubz_torch, data, stream, tmp)
    files(tpubz_torch, short, got, tmp)
    _no_reference_modules()

    sorts = [
        ("bitonic_1op", "tools/probe_pallas_sort.py:110", sort_calls["bitonic_1op"],
         sort_ms["bitonic_1op"]),
        ("bitonic_2op", "tools/probe_pallas_sort.py:121", sort_calls["bitonic_2op"],
         sort_ms["bitonic_2op"]),
        ("stage_passes", "tools/probe_pallas_pass.py:83", pass_launches, stage_ms["row2"]),
    ]
    rows = {name: {
        "name": name,
        "route": "cuda",
        "source": f"tpubz_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": chain[name]["max_abs_err"],
        "ms": chain[name]["ms"],
        "plain_ms": chain[name]["plain_ms"],
        "bound_ms": chain[name]["bound"][0],
        "bound_by": chain[name]["bound"][1],
        "library_ms": None,
    } for name, replaces in (("bwt", "tpubz/kernels/suffix_sort.py:50"),
                             ("mtf", "tpubz/kernels/mtf_pallas.py:46"),
                             ("rle2", "tpubz/kernels/rle2.py:34"))}
    print(json.dumps({"kernels": [rows["bwt"], rows["mtf"]] + [{
        "name": name,
        "route": "cuda",
        "source": "tpubz_torch/csrc/bitonic.cu",
        "replaces": replaces,
        "launches": n,
        "max_abs_err": sort_err[name],
        "ms": times[0],
        "plain_ms": times[1],
        "bound_ms": times[3][0],
        "bound_by": times[3][1],
        "library_ms": times[2],
    } for name, replaces, n, times in sorts] + [rows["rle2"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def chain_kernels(padded, n0, edges, rng):
    """The MTF and RLE2 kernels against their plain versions on the card,
    exactly (every lane, the used map, every symbol slot, the length and the
    frequencies; the EOB a device scalar): on the BWT of the corpus's first
    block and of each edge block, and RLE2 also on random ranks with zero
    runs up to 70,000 long. Then their ms and the plain versions' on the
    corpus block, and the bounds. Returns per kernel max_abs_err, ms,
    plain_ms and bound."""
    from tpubz_torch.kernels import mtf, rle2
    from tpubz_torch.kernels.suffix_sort import bwt_forward

    dev, N = padded.device, padded.shape[0]
    blocks = {"corpus_block0": bwt_forward(padded, n0)[1]}
    for name, blk in edges.items():
        data = torch.zeros(N, dtype=torch.uint8, device=dev)
        data[: len(blk)] = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(dev)
        blocks[name] = bwt_forward(data, len(blk))[1]
    lengths = {"corpus_block0": n0, **{k: len(v) for k, v in edges.items()}}
    err = {"mtf": 0, "rle2": 0}

    def held(kernel, inputs, got, ref):
        torch.cuda.synchronize()
        mismatches = sum(int((g != r).sum()) for g, r in zip(got, ref))
        e = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))
        err[kernel] = max(err[kernel], e)
        _say("kernel", f"{kernel} vs plain inputs={inputs} N={N} mismatches={mismatches} "
                f"max_abs_err={e} tolerance=0")
        if mismatches:
            raise AssertionError(f"{kernel} disagrees with its plain version on {inputs}")

    ranks = {}
    for name, last in blocks.items():
        n = lengths[name]
        got = mtf.mtf_ranks(last, n)
        held("mtf", name, got, mtf.mtf_ranks_ref(last, n))
        ranks[name] = (got[0], n, got[1].sum() + 1)
    runs = np.zeros(N, np.int32)
    at = int(rng.integers(0, 100))
    while at < N:
        runs[at] = rng.integers(1, 256)
        at += 1 + int(rng.choice([0, 1, 3, 30, 700, 5000, 70_000]))
    ranks["random_zero_runs"] = (torch.from_numpy(runs).to(dev), N - 1000,
                                 torch.tensor(201, device=dev))
    for name, (r, n, eob) in ranks.items():
        held("rle2", name, rle2.rle2_encode(r, n, eob), rle2.rle2_encode_ref(r, n, eob))

    last, (r, n, eob) = blocks["corpus_block0"], ranks["corpus_block0"]
    nc = N // mtf.CHUNK
    out = {
        # bytes in, ranks and the used map out; no operation count is
        # needed beyond one per position
        "mtf": (lambda: mtf.mtf_ranks(last, n0), lambda: mtf.mtf_ranks_ref(last, n0),
                _bound(N + 4 * N + 256, N)),
        # ranks in, symbols, length and frequencies out
        "rle2": (lambda: rle2.rle2_encode(r, n, eob), lambda: rle2.rle2_encode_ref(r, n, eob),
                 _bound(4 * N + 4 * (N + 8) + 8 + 8 * 258, N)),
    }
    result = {}
    for name, (run, plain, bound) in out.items():
        module = mtf if name == "mtf" else rle2
        before = module.LAUNCHES
        run()
        torch.cuda.synchronize()
        calls = module.LAUNCHES - before
        ms, plain_ms = _cuda_ms(run, 50), _cuda_ms(plain, 5)
        result[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms, "bound": bound}
        # the TPU formulation's dominance compares (two for each of 256*255/2
        # pairs and 256*256 for srank, per chunk) at the int32 rate, beside
        extra = (f"tpu_formulation_compares_int32_us="
                 f"{nc * (256 * 255 + 256 * 256) / INT32_OPS_PER_S * 1e6} " if name == "mtf" else "")
        _say("kernel", f"{name} N={N} n={n0} kernel_ms={ms} plain_ms={plain_ms} "
                f"calls_per_block={calls} kernels_per_call=3 bound_us={bound[0] * 1e3} "
                f"bound_by={bound[1]} {extra}(CUDA events, inputs=corpus_block0)")
    return result


def bwt_kernels(padded, n0, edges):
    """The BWT's library call against its plain version on the card, exactly
    (the key and every lane of the last column), on the corpus's first block
    and each edge block; a 1op sort must run for the blocks with tied
    rotations and for no other. Then the call's ms and the plain version's
    on the corpus block (CUDA events; the call waits for each round's class
    count, one round behind the card), its rounds, and the bounds of the
    call and of each of its kernels."""
    from tpubz_torch.kernels import bitonic, suffix_sort
    from tpubz_torch.kernels.suffix_sort import bwt_forward, bwt_forward_ref

    dev, N = padded.device, padded.shape[0]
    inputs = {"corpus_block0": (padded, n0)}
    for name, blk in edges.items():
        data = torch.zeros(N, dtype=torch.uint8, device=dev)
        data[: len(blk)] = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(dev)
        inputs[name] = (data, len(blk))
    tied = {"one_byte_run", "all256"}
    err = 0
    for name, (data, n) in inputs.items():
        before = (suffix_sort.LAUNCHES, suffix_sort.ROUNDS_RUN, bitonic.CALLS["bitonic_1op"])
        key, last = bwt_forward(data, n)
        torch.cuda.synchronize()
        calls = suffix_sort.LAUNCHES - before[0]
        rounds = suffix_sort.ROUNDS_RUN - before[1]
        one_op = bitonic.CALLS["bitonic_1op"] - before[2]
        rkey, rlast = bwt_forward_ref(data, n)
        mismatches = int(key != rkey) + int((last != rlast).sum())
        e = max(abs(int(key) - int(rkey)), int((last.int() - rlast.int()).abs().max()))
        err = max(err, e)
        _say("kernel", f"bwt vs plain inputs={name} n={n} N={N} rounds={rounds} "
                f"round_cap={suffix_sort.call_sizes(n)[2]} one_op_sorts={one_op} "
                f"mismatches={mismatches} max_abs_err={e} tolerance=0")
        if mismatches:
            raise AssertionError(f"bwt_forward disagrees with its plain version on {name}")
        if calls != 1 or one_op != (name in tied):
            raise AssertionError(f"bwt_forward on {name}: {calls} calls, {one_op} 1op sorts")
    before = suffix_sort.ROUNDS_RUN
    bwt_forward(padded, n0)
    rounds = suffix_sort.ROUNDS_RUN - before
    ms = _cuda_ms(lambda: bwt_forward(padded, n0), 20)
    plain_ms = _cuda_ms(lambda: bwt_forward_ref(padded, n0), 5)
    # what a BWT of these bytes needs, whatever the algorithm: the block read
    # and the column and key written once, against the n log2 n compares of a
    # comparison sort of its rotations. The compares this formulation does (a
    # bitonic network per round) are printed beside it and are no bound.
    P = suffix_sort.padded_length(n0)
    bound = _bound(n0 + N + 8, n0 * math.log2(n0))
    sorts_compares = rounds * len(bitonic.network(P.bit_length() - 1)) * P // 2
    # each kernel alone: what it reads and writes once, one operation a lane
    parts = {
        "bwt_seed_keys": _bound(n0 + 12 * P, P),
        "bwt_round_keys": _bound(2 * 4 * n0 + 12 * P, P),
        "bwt_rerank_count+bwt_rerank": _bound(12 * n0 + 4 * n0, n0),
        "bwt_last_column": _bound(n0 + 4 * n0 + N + 8, N),
    }
    _say("kernel", f"bwt N={N} n={n0} kernel_ms={ms} plain_ms={plain_ms} rounds={rounds} "
            f"calls_per_block=1 bound_us={bound[0] * 1e3} bound_by={bound[1]} "
            f"this_formulation_compares_int32_us={sorts_compares / INT32_OPS_PER_S * 1e6} "
            + " ".join(f"{k}_bound_us={v[0] * 1e3}" for k, v in parts.items())
            + " (CUDA events, inputs=corpus_block0)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound}


def stage_bwt(tpubz_torch, data, stream):
    """The bwt stage, device-only, on the main path's data: the same bytes,
    the BWT's library call on every block and no MTF or RLE2 kernel (they
    lie off this stage)."""
    from tpubz_torch.kernels import bitonic, mtf, rle2, suffix_sort
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
    if suffix_sort.LAUNCHES != st["blocks"] or calls["bitonic_2op"] < st["blocks"]:
        raise AssertionError(f"{suffix_sort.LAUNCHES} BWT calls, bitonic sorts {calls} for "
                             f"{st['blocks']} blocks")
    if mtf.LAUNCHES or rle2.LAUNCHES:
        raise AssertionError(f"{mtf.LAUNCHES} MTF and {rle2.LAUNCHES} RLE2 launches on the bwt stage")
    mb = len(data) / 1e6
    _say("stage_bwt", f"blocks={st['blocks']} stream==path_stream "
         f"bwt_launches={suffix_sort.LAUNCHES} bwt_rounds={suffix_sort.ROUNDS_RUN} "
         f"bitonic_sorts={calls} pass_kernel_launches={bitonic.PASS_LAUNCHES} "
         f"mtf_launches=0 rle2_launches=0 MB={mb} seconds={dt} MBps={mb / dt}")


def hybrid(tpubz_torch, data, stream, tmp):
    """The default routing (hybrid CPU pool, stage from a fresh profile) on
    the main path's data, then compress_cpu on the same data."""
    from tpubz_torch.kernels import bitonic, mtf, rle2, suffix_sort
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
         f"stream==path_stream bwt_launches={suffix_sort.LAUNCHES} "
         f"bitonic_sorts={dict(bitonic.CALLS)} "
         f"mtf_launches={mtf.LAUNCHES} rle2_launches={rle2.LAUNCHES} MB={mb} seconds={dt} "
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

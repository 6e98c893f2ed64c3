#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpubz_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and g++.
It builds the port's native host engine (tpubz_torch/native, g++) and the
CUDA kernels (tpubz_torch/csrc, nvcc) into tpubz_torch/_build, holds each
kernel against its plain
PyTorch version at the level-9 shapes (tolerance 0: the codec is integer;
MTF and RLE2 on the corpus's first block and the three edge blocks, RLE2
also on random ranks with long zero runs, with the EOB as a device scalar
and from the used map, and 20 repeats of each RLE2 form identical, since
its tiles race through a look-back; the BWT's library call, key and
every lane of the last column, on the same four blocks, 20 calls equal on
the corpus and near-periodic blocks (graph replays, look-back races); the
radix sort under it on random 60-bit keys, on the keys of the corpus
block's doubling rounds 0, 1 and 3 and of the near-periodic block's round
5, 20 calls equal on each),
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
([files]), each byte-equal to tpubz_torch.compress. The scalar codec
(tpubz_torch/hostref: numpy and Python lists, sharing no code with the
kernels or the native engine) then holds the card's main-path kernels and
stream ([oracle], tolerance 0): the card's short level-9 stream (the 3 MiB
prefix and the edge blocks) byte-equal to hostref.stream.compress; on each
of its level-9 blocks and the ab...abc and bytes(range(256)) * 3500 edge
blocks the card's BWT key and last column equal to hostref.bwt.bwt_encode's
and its RLE2 symbols, length, frequencies and used map to
hostref.mtf_rle2.mtf_rle2_encode's of the scalar last column (the BWT, MTF
and RLE2 kernels launched, no plain version); the scalar decoder, traced
into a counting handler, gives the short data back; python -m tpubz_torch
-d --trace-bits on the card's stream of a 256 KiB prefix writes it back with
its trace on stderr, and cli.run(prog="tpcat") to stdout, each in a
subprocess. The phase prints the scalar codec's seconds. The multi-process path
([multihost]) runs this script as two gloo ranks on the one card
(``--rank R --world W --port P --job PATH``, a TCPStore on a free
127.0.0.1 port): compress_multihost at level 9 on a 10-block cut of the
main path's data (corpus blocks, a random block, bytes(range(256)) * 3500,
a block whose symbols >= 256 overflow the compact form's sidecar, the
periodic tail), byte-equal to tpubz_torch.compress and compress_cpu,
round-tripped through decompress_multihost on two ranks and bunzip2, a
corrupt copy raising on both ranks; each rank must have launched all four
batched kernels (the batched BWT, MTF and RLE2 and the compact form, held
before against their plain versions and the one-block kernels on five
level-9 rows at once) and no one-block kernel; then one rank on the same
data for its MB/s (the compact form held at B = 1, 3, 4 and 5, on rows at
an odd element offset, and 20 calls equal). The device refine encoder
([devrefine]) encodes
[path]'s blocks with DeviceBlockEncoder.transform and
encode_block_devrefine, and again as rows of the batched transform, each
row's symbols a view into the batch; both streams must equal [path]'s and
round-trip, refine_pass (one launch a pass, over the block's symbols) and
the packer must have launched, the histograms (off the refinement's path)
not, and no plain version run (the kernels are held first against their
plain versions: the histograms on the corpus block, the edge blocks, the
sidecar overflow block and the five batch rows, the refinement pass on
those blocks' symbols for every table count and a forced tie and on each
batch row, the packer on 2^20 seeded fields (into more words than its
tiles reach, and as views at odd element offsets), the payload on each
block's final tables, with uint16 symbols and a device length and with
int32 symbols and a host length, on the corpus block at stream lengths
around a tile, and on each batch row with seeded tables; the packer, the
payload and the compact form must each be one launch a call on the card,
by torch.profiler). The lean chain ([lean]) runs
DeviceBlockEncoder.transform(blk, lean=True) on [path]'s blocks and the
sidecar overflow block, each fetch equal to the int16 form's field by
field, and encode_block (which takes the lean chain) on [path]'s blocks,
spliced, equal to [path]'s stream and round-tripped; rle2_compact must
have launched on every lean transform and its plain version never. The
inverse BWT ([ibwt]) runs bwt_inverse_device on every block's (key, last
column) from transform_bwt, each equal to the RLE1 block, with its next
pointers and the orbit's three kernels on the card (the splitter walks and
the rank, as the call's record counts them: L the length of p_0's cycle,
the segments and the longest walk) and no plain version; it prints its ms
a block beside decompress's. Those kernels are
held first against their plain versions: rle2_compact on the MTF ranks of
the corpus block, the edge blocks, the sidecar overflow block and random
ranks with long zero runs and EOB 257; next_pointers and the inverse on
those blocks' BWT, a shorter block with pad lanes and n = 0, 1, 2. Every
phase prints one line; any failure raises, so the script exits non-zero
without the final line. Without a CUDA device it exits with code 1 and
prints no result.

The line before the last is {"kernels": [...]}: per kernel its launches in
the main-path run, its largest difference from the plain version, its time,
the plain version's and the one-call PyTorch equivalent's where one exists
(torch.sort for the sorts), all from CUDA events, and its bound: the larger
of the bytes it must move over 3.35 TB/s and its integer operations over
the int32 rate of the card's CUDA cores (132 SMs x 64 lanes x 1.98 GHz,
16.7 T/s; the data sheet's 67 TFLOP/s is the float32 rate: twice the
lanes, and an FMA counted as two). The MTF and RLE2 launches are calls of
their wrappers (MTF three kernels, RLE2 a memset and one kernel, as its
wrapper reports them); the BWT's are calls of its wrapper (one library call a
block: a graph whose loop runs a doubling round a pass of its body on the
card, the large classes' keys with their histogram and radix passes, the
small classes' shared-memory sort, the re-rank; then the last column);
the radix sort's are the sorts run on the card, which on the main path
are the BWT call's: one in each round whose list of large classes was not
empty, as the card counted them. The
bitonic sorts (and stage_passes, the launches of the two pass kernels
bitonic_global and bitonic_tile) left the main path when the BWT moved to
the radix sort: their main-path launches are 0, and [path] fails if one
ran. The four batched kernels (bwt_batch, mtf_batch, rle2_batch, compact)
count their calls in the [multihost] phase, both ranks summed; their
times are at B = 5 level-9 rows. The five device refine rows (chunk_hist,
chunk_hist_batch, refine_pass, pack_bits, pack_payload) count their calls
in the [devrefine] phase, both of its legs (the histograms 0: the passes
read the symbols); pack_bits counts the launches
of the packing kernel, which pack_payload launches with the gather fused
into it; their times are on the corpus's first block (the five rows for
the batch, 2^20 fields for pack_bits), with torch.bincount of the flat
index beside the histograms. rle2_compact counts its calls in [lean] (the
full stage fetches the int16 form); next_pointers (torch.sort(stable=True) beside it) and bwt_inverse
count theirs in [ibwt], each inverse call running the next pointers once;
their times are on the corpus's first block. The port imports neither tpubz nor jax,
and the run
checks that neither was loaded. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import hashlib
import json
import logging
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


def _check_bwt_record(record, name):
    """A finished one-block BWT call's record, as the card counted it: every
    body kernel of csrc/bwt.cu launched once a round and the radix passes as
    many times a round as the library gives; a sort in round 0 and in every
    later round whose large list (the record's per-round word) was not
    empty, each of its passes run or skipped."""
    from tpubz_torch.kernels import suffix_sort

    rounds, n_passes = record["rounds"], suffix_sort.call_sizes(1)[3]
    want = {k: rounds * (n_passes if k == "bwt_pass" else 1) for k in suffix_sort.BODY}
    got = {k: record[k] for k in suffix_sort.BODY}
    sorts = int(rounds > 0) + sum(int(w[3] > 0) for w in record["words"][:-1])
    if (got != want or record["sorts"] != sorts
            or record["passes_run"] + record["skipped"] != n_passes * sorts):
        raise AssertionError(f"bwt_forward on {name}: the card counted {got} launches, "
                             f"{record['sorts']} sorts, {record['passes_run']} passes run and "
                             f"{record['skipped']} skipped in {rounds} rounds ({sorts} with a "
                             f"large list)")


def _zero_counts():
    from tpubz_torch.kernels import bitonic, compact, ibwt, mtf, radix, rle2, suffix_sort

    mtf.LAUNCHES = rle2.LAUNCHES = compact.LEAN_LAUNCHES = 0
    ibwt.finish_calls()
    ibwt.NEXT_LAUNCHES = ibwt.INVERSE_LAUNCHES = ibwt.KERNEL_LAUNCHES = 0
    suffix_sort.LAUNCHES = suffix_sort.ROUNDS_RUN = suffix_sort.KERNEL_LAUNCHES = 0
    suffix_sort.ACTIVE_SORTED = suffix_sort.PASSES_RUN = suffix_sort.PASSES_SKIPPED = 0
    suffix_sort.HOST_US.update(dict.fromkeys(suffix_sort.HOST_US, 0))
    radix.LAUNCHES = radix.SORTS = radix.PASS_LAUNCHES = 0
    bitonic.LAUNCHES = bitonic.PASS_LAUNCHES = 0
    bitonic.CALLS.update(dict.fromkeys(bitonic.CALLS, 0))


class _PhaseClock:
    """Seconds between marks, by the name of the part that just ended."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def mark(self, name):
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def _bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time for nbytes moved once
    and ops int32 operations, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _one_launch(run, kernel, name):
    """torch.profiler's record of one call of run (stage_probe's
    kernel_device_us), which must be one launch of `kernel`. A session
    that traced no device event at all is taken again, up to three times:
    the profiler, not the call, missed it."""
    from tpubz_torch.stage_probe import kernel_device_us

    for attempt in range(1, 4):
        prof = kernel_device_us(run)
        if prof["launches"]:
            break
    if prof["launches"] != 1 or not all(kernel in k for k in prof["kernels_us"]):
        raise AssertionError(f"a {name} call ran {prof['kernels_launches']} on the card "
                             f"(profiler sessions: {attempt})")
    return prof


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
    from tpubz_torch.corpus import edge_blocks, mixed_corpus, with_tied_tail
    from tpubz_torch import native
    from tpubz_torch.kernels import _build, bitonic, mtf, radix, rle2, suffix_sort
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
    data = with_tied_tail(corpus + b"".join(edges.values()), LEVEL)
    _say("corpus", f"corpus=mixed_corpus({CORPUS_MIB}, seed={SEED}) corpus_bytes={len(corpus)} "
            f"corpus_sha256={hashlib.sha256(corpus).hexdigest()} "
            f"with_edges_and_tied_tail_bytes={len(data)} "
            f"with_edges_and_tied_tail_sha256={hashlib.sha256(data).hexdigest()}")

    N = block_n(LEVEL)
    n0 = LEVEL * 100_000
    padded = torch.zeros(N, dtype=torch.uint8, device=dev)
    padded[:n0] = torch.frombuffer(bytearray(corpus[:n0]), dtype=torch.uint8).to(dev)
    rng = np.random.default_rng(SEED)
    clock = _PhaseClock()
    chain = chain_kernels(padded, n0, edges, rng)
    chain["bwt"] = bwt_kernels(padded, n0, edges)
    chain["radix"] = radix_kernels(padded, n0, rng)
    clock.mark("kernel_chain")
    batch = batch_kernels(corpus, edges, rng)
    clock.mark("kernel_batch")
    dref = devrefine_kernels(corpus, edges)
    clock.mark("kernel_devrefine")
    li = lean_ibwt_kernels(padded, n0, edges)
    clock.mark("kernel_lean_ibwt")

    # the bitonic kernels against their plain versions at 2^20, exactly:
    # int32 keys in [0, 50), whose duplicates move payloads by the tie rule;
    # the int64 keys of block 0's first doubling round, padded with
    # INT64_MAX (the BWT once sorted its keys with them); the TPU probe's
    # stage cases
    L = 1 << bitonic.MAX_LOG2
    k32 = torch.from_numpy(rng.integers(0, 50, L).astype(np.int32)).to(dev)
    p32 = torch.from_numpy(rng.permutation(L).astype(np.int32)).to(dev)
    r32 = torch.from_numpy(rng.integers(0, 1 << 30, L).astype(np.int32)).to(dev)
    k64 = torch.full((L,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
    k64[:n0] = suffix_sort.round_keys(padded[:n0], 0)
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
    launches = {"mtf": mtf.LAUNCHES, "rle2": rle2.LAUNCHES, "bwt": suffix_sort.LAUNCHES,
                "radix": radix.SORTS}
    rounds, bwt_kernel_launches = suffix_sort.ROUNDS_RUN, suffix_sort.KERNEL_LAUNCHES
    active_sorted, radix_passes = suffix_sort.ACTIVE_SORTED, radix.PASS_LAUNCHES
    passes_run, skipped = suffix_sort.PASSES_RUN, suffix_sort.PASSES_SKIPPED
    bwt_host_us = dict(suffix_sort.HOST_US)
    sort_calls = dict(bitonic.CALLS)
    pass_launches = bitonic.PASS_LAUNCHES
    blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
    if tpubz_torch.decompress(stream) != data:
        raise AssertionError("tpubz_torch.decompress round trip failed")
    ran = ["tpubz_torch.decompress"] + ["bunzip2"] * _bunzip2_ok(stream, data)
    _say("stream", f"stream_bytes={len(stream)} ratio={len(stream) / len(data)} "
            f"round_trips={'+'.join(ran)}")

    # the main path went through the kernels, without jax: every block ran
    # the BWT's library call, its MTF and its RLE2. The card counted what
    # the call's graph ran: a round of its body a doubling round (at least
    # one a block), each body kernel of csrc/bwt.cu launched once a round
    # and the radix passes as often as the library gives a round, besides
    # the setup and the last column a call (counted on the host); a radix
    # sort in every round whose large list was not empty (round 0's always),
    # each of its passes either run or skipped; no bitonic sort ran
    n_passes = suffix_sort.call_sizes(1)[3]
    per_round, per_call = suffix_sort.launch_sizes()
    if min(launches.values()) < blocks:
        raise AssertionError(f"BWT, MTF, RLE2 and radix launches {launches} for {blocks} blocks")
    if (not blocks <= launches["radix"] <= rounds or radix_passes != n_passes * rounds
            or passes_run + skipped != n_passes * launches["radix"]):
        raise AssertionError(f"{launches['radix']} radix sorts with {radix_passes} pass launches "
                             f"({passes_run} run, {skipped} skipped) for {rounds} rounds in "
                             f"{blocks} blocks")
    if (any(sort_calls.values()) or pass_launches
            or bwt_kernel_launches != per_round * rounds + per_call * launches["bwt"]):
        raise AssertionError(f"bitonic sorts {sort_calls} ({pass_launches} pass kernels) and "
                             f"{bwt_kernel_launches} BWT-kernel launches in {rounds} rounds")
    _no_reference_modules()
    mb = len(data) / 1e6
    _say("path", f"blocks={blocks} bwt_launches={launches['bwt']} bwt_rounds={rounds} "
            f"bwt_active_rotations_sorted={active_sorted} "
            f"bwt_kernel_launches={bwt_kernel_launches} radix_sorts={launches['radix']} "
            f"radix_pass_launches={radix_passes} radix_passes_run={passes_run} "
            f"radix_passes_skipped={skipped} "
            f"bwt_host_us={json.dumps(bwt_host_us, separators=(',', ':'))} "
            f"mtf_launches={launches['mtf']} "
            f"rle2_launches={launches['rle2']} "
            f"bitonic_wrapper_calls={bitonic.LAUNCHES} bitonic_sorts={sort_calls} "
            f"bitonic_pass_kernel_launches={pass_launches} MB={mb} seconds={dt} "
            f"MBps={mb / dt} tpubz_imported=False jax_imported=False")

    clock.mark("bitonic_bwt_short_path")
    stage_bwt(tpubz_torch, data, stream)
    clock.mark("stage_bwt")
    hybrid(tpubz_torch, data, stream, tmp)
    clock.mark("hybrid")
    files(tpubz_torch, short, got, tmp)
    clock.mark("files")
    oracle(tpubz_torch, short, got, edges, tmp)
    clock.mark("oracle")
    mh_launches = multihost(tpubz_torch, corpus, edges, rng, tmp)
    clock.mark("multihost")
    dref_launches = devrefine(tpubz_torch, data, stream)
    clock.mark("devrefine")
    li_launches = lean(tpubz_torch, data, stream)
    clock.mark("lean")
    li_launches.update(inverse(tpubz_torch, data, stream))
    clock.mark("ibwt")
    _no_reference_modules()
    _say("timing", " ".join(f"{k}_s={v}" for k, v in clock.seconds.items())
         + " (host clock from the end of the build; the kernel checks, then the phases)")

    # the bitonic sorts' main-path launches: 0 (checked above)
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
        "library_ms": chain[name].get("library_ms"),
    } for name, replaces in (("bwt", "tpubz/kernels/suffix_sort.py:50"),
                             ("radix", "tpubz/kernels/suffix_sort.py:106"),
                             ("mtf", "tpubz/kernels/mtf_pallas.py:46"),
                             ("rle2", "tpubz/kernels/rle2.py:34"))}
    print(json.dumps({"kernels": [rows["bwt"], rows["radix"], rows["mtf"]] + [{
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
    } for name, replaces, n, times in sorts] + [rows["rle2"]] + [{
        "name": name,
        "route": "cuda",
        "source": f"tpubz_torch/csrc/{source}",
        "replaces": replaces,
        "launches": mh_launches[name],
        "max_abs_err": batch[name]["max_abs_err"],
        "ms": batch[name]["ms"],
        "plain_ms": batch[name]["plain_ms"],
        "bound_ms": batch[name]["bound"][0],
        "bound_by": batch[name]["bound"][1],
        "library_ms": None,
    } for name, source, replaces in (
        ("bwt_batch", "bwt.cu", "tpubz/kernels/suffix_sort.py:170"),
        ("mtf_batch", "mtf.cu", "tpubz/kernels/mtf.py:166"),
        ("rle2_batch", "rle2.cu", "tpubz/kernels/rle2.py:113"),
        ("compact", "compact.cu", "tpubz/block/encode.py:99"))] + [{
        "name": name,
        "route": "cuda",
        "source": f"tpubz_torch/csrc/{source}",
        "replaces": replaces,
        "launches": dref_launches[name],
        "max_abs_err": dref[name]["max_abs_err"],
        "ms": dref[name]["ms"],
        "plain_ms": dref[name]["plain_ms"],
        "bound_ms": dref[name]["bound"][0],
        "bound_by": dref[name]["bound"][1],
        "library_ms": dref[name].get("library_ms"),
    } for name, source, replaces in (
        ("chunk_hist", "huffman_dev.cu", "tpubz/kernels/huffman_dev.py:53"),
        ("chunk_hist_batch", "huffman_dev.cu", "tpubz/kernels/huffman_dev.py:118"),
        ("refine_pass", "huffman_dev.cu", "tpubz/kernels/huffman_dev.py:68"),
        ("pack_bits", "bitpack.cu", "tpubz/kernels/bitpack.py:14"),
        ("pack_payload", "bitpack.cu", "tpubz/kernels/huffman_dev.py:93"))] + [{
        "name": name,
        "route": "cuda",
        "source": f"tpubz_torch/csrc/{source}",
        "replaces": replaces,
        "launches": count,
        "max_abs_err": li[name]["max_abs_err"],
        "ms": li[name]["ms"],
        "plain_ms": li[name]["plain_ms"],
        "bound_ms": li[name]["bound"][0],
        "bound_by": li[name]["bound"][1],
        "library_ms": li[name]["library_ms"],
    } for name, source, replaces, count in (
        ("rle2_compact", "rle2.cu", "tpubz/block/encode.py:167", li_launches["rle2_compact"]),
        ("next_pointers", "ibwt.cu", "tpubz/kernels/ibwt.py:32", li_launches["next_pointers"]),
        ("bwt_inverse", "ibwt.cu", "tpubz/kernels/ibwt.py:47", li_launches["bwt_inverse"]))]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def chain_kernels(padded, n0, edges, rng):
    """The MTF and RLE2 kernels against their plain versions on the card,
    exactly (every lane, the used map, every symbol slot, the length and the
    frequencies; the EOB a device scalar, and from the used map as the
    transform takes it): on the BWT of the corpus's first block and of each
    edge block, and RLE2 also on random ranks with zero runs up to 70,000
    long. RLE2's look-back is then run 20 times on the corpus block and the
    random ranks, every output identical. Then their ms and the plain
    versions' on the corpus block (RLE2 as the transform calls it), device
    µs and launches from torch.profiler, the launches each wrapper reports,
    and the bounds. Returns per kernel max_abs_err, ms, plain_ms and
    bound."""
    from tpubz_torch.kernels import mtf, rle2
    from tpubz_torch.kernels.suffix_sort import bwt_forward
    from tpubz_torch.stage_probe import kernel_device_us

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
        mismatches = sum(int((g.long() != r.long()).sum()) for g, r in zip(got, ref))
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
        ranks[name] = (got[0], n, got[1])
    runs = np.zeros(N, np.int32)
    at = int(rng.integers(0, 100))
    while at < N:
        runs[at] = rng.integers(1, 256)
        at += 1 + int(rng.choice([0, 1, 3, 30, 700, 5000, 70_000]))
    used_200 = torch.arange(256, device=dev) < 200  # EOB 201
    ranks["random_zero_runs"] = (torch.from_numpy(runs).to(dev), N - 1000, used_200)
    for name, (r, n, used) in ranks.items():
        eob = used.sum() + 1
        want = rle2.rle2_encode_ref(r, n, eob)
        held("rle2", f"{name} eob=device_scalar", rle2.rle2_encode(r, n, eob), want)
        held("rle2", f"{name} eob=used_map", rle2.rle2_encode_used(r, n, used), want)
    # the look-back's races: 20 calls on the same ranks, every output equal
    for name in ("corpus_block0", "random_zero_runs"):
        r, n, used = ranks[name]
        first = [t.clone() for t in rle2.rle2_encode_used(r, n, used)]
        differing = 0
        for _ in range(19):
            again = rle2.rle2_encode_used(r, n, used)
            differing += sum(int((a.long() != b.long()).sum()) for a, b in zip(first, again))
        torch.cuda.synchronize()
        _say("kernel", f"rle2 repeats inputs={name} calls=20 differing_slots={differing}")
        if differing:
            raise AssertionError(f"rle2_encode_used gave different outputs on {name}")

    last, (r, n, used) = blocks["corpus_block0"], ranks["corpus_block0"]
    eob = used.sum() + 1
    nc = N // mtf.CHUNK
    out = {
        # bytes in, ranks and the used map out; no operation count is
        # needed beyond one per position
        "mtf": (lambda: mtf.mtf_ranks(last, n0), lambda: mtf.mtf_ranks_ref(last, n0),
                _bound(N + 4 * N + 256, N)),
        # ranks and the used map in; uint16 symbols, length and frequencies out
        "rle2": (lambda: rle2.rle2_encode_used(r, n, used), lambda: rle2.rle2_encode_ref(r, n, eob),
                 _bound(4 * N + 256 + 2 * (N + 8) + 8 + 8 * 258, N)),
    }
    result = {}
    for name, (run, plain, bound) in out.items():
        module = mtf if name == "mtf" else rle2
        before, kernels_before = module.LAUNCHES, rle2.KERNEL_LAUNCHES
        run()
        torch.cuda.synchronize()
        calls = module.LAUNCHES - before
        kernels = rle2.KERNEL_LAUNCHES - kernels_before  # RLE2's memset and kernel
        ms, plain_ms = _cuda_ms(run, 50), _cuda_ms(plain, 5)
        prof = _one_launch(run, "compact_rows", name) if name == "compact" else kernel_device_us(run)
        result[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms, "bound": bound,
                        "device_us": prof["sum_us"]}
        extra = ""
        if name == "mtf":
            # the TPU formulation's dominance compares (two for each of
            # 256*255/2 pairs and 256*256 for srank, per chunk) at the int32
            # rate, beside
            extra = (f"tpu_formulation_compares_int32_us="
                     f"{nc * (256 * 255 + 256 * 256) / INT32_OPS_PER_S * 1e6} ")
        else:
            per_call = kernels // max(calls, 1)
            if per_call > 2:
                raise AssertionError(f"rle2_encode_used enqueued {per_call} launches a call")
            eob_ms = _cuda_ms(lambda: rle2.rle2_encode(r, n, eob), 50)
            extra = (f"kernels_per_call={per_call} (the memset and the kernel, as the wrapper "
                     f"reports them) eob_scalar_ms={eob_ms} ")
        _say("kernel", f"{name} N={N} n={n0} kernel_ms={ms} plain_ms={plain_ms} "
                f"calls_per_block={calls} device_us={prof['sum_us']} "
                f"device_launches={prof['launches']} bound_us={bound[0] * 1e3} "
                f"bound_by={bound[1]} {extra}(CUDA events; device time from torch.profiler, "
                f"one call; inputs=corpus_block0)")
    return result


def bwt_kernels(padded, n0, edges):
    """The BWT's library call against its plain version on the card, exactly
    (the key and every lane of the last column), on the corpus's first block
    and each edge block; each call's record, as the card counted it, must
    hold every body kernel once a round, a radix sort in each round with a
    large list, and no bitonic sort may run; 20 calls on the corpus block and on the near-periodic
    block (the graph replayed, the look-backs racing) give the same key and
    column. Then the call's ms and the plain version's on the corpus block
    (CUDA events; the rounds run on the card, the call waits once, after
    its last column), its rounds, active rotations and each round's large
    and small lists, and the bounds: what any BWT of the block needs, what
    this formulation moves on this block's data, and what each of its
    kernels moves."""
    from tpubz_torch.kernels import bitonic, radix, suffix_sort
    from tpubz_torch.kernels.suffix_sort import bwt_forward, bwt_forward_ref

    dev, N = padded.device, padded.shape[0]
    inputs = {"corpus_block0": (padded, n0)}
    for name, blk in edges.items():
        data = torch.zeros(N, dtype=torch.uint8, device=dev)
        data[: len(blk)] = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(dev)
        inputs[name] = (data, len(blk))
    err = 0
    for name, (data, n) in inputs.items():
        before = (suffix_sort.LAUNCHES, suffix_sort.ROUNDS_RUN, suffix_sort.ACTIVE_SORTED,
                  radix.SORTS, bitonic.PASS_LAUNCHES)
        key, last, call = suffix_sort.bwt_forward_async(data, n)
        call.finish()
        calls = suffix_sort.LAUNCHES - before[0]
        rounds = suffix_sort.ROUNDS_RUN - before[1]
        active = suffix_sort.ACTIVE_SORTED - before[2]
        sorts = radix.SORTS - before[3]
        _check_bwt_record(call.rows[0], name)
        rkey, rlast = bwt_forward_ref(data, n)
        mismatches = int(key != rkey) + int((last != rlast).sum())
        e = max(abs(int(key) - int(rkey)), int((last.int() - rlast.int()).abs().max()))
        err = max(err, e)
        _say("kernel", f"bwt vs plain inputs={name} n={n} N={N} rounds={rounds} "
                f"active_rotations_sorted={active} round_cap={suffix_sort.call_sizes(n)[2]} "
                f"radix_sorts={sorts} mismatches={mismatches} max_abs_err={e} tolerance=0")
        if mismatches:
            raise AssertionError(f"bwt_forward disagrees with its plain version on {name}")
        if calls != 1 or bitonic.PASS_LAUNCHES != before[4]:
            raise AssertionError(f"bwt_forward on {name}: {calls} calls, {sorts} radix sorts in "
                                 f"{rounds} rounds, {bitonic.PASS_LAUNCHES - before[4]} "
                                 f"bitonic launches")
    for name in ("corpus_block0", "near_periodic"):
        data, n = inputs[name]
        want = bwt_forward(data, n)
        differing = sum(int(k != want[0]) + int((c != want[1]).sum())
                        for k, c in (bwt_forward(data, n) for _ in range(19)))
        _say("kernel", f"bwt repeats inputs={name} calls=20 differing_slots={differing}")
        if differing:
            raise AssertionError(f"bwt_forward gave different outputs on a repeat of {name}")
    before = (suffix_sort.ROUNDS_RUN, suffix_sort.ACTIVE_SORTED, suffix_sort.KERNEL_LAUNCHES,
              radix.PASS_LAUNCHES, suffix_sort.PASSES_SKIPPED)
    _, _, call = suffix_sort.bwt_forward_async(padded, n0)
    call.finish()
    rounds = suffix_sort.ROUNDS_RUN - before[0]
    active = suffix_sort.ACTIVE_SORTED - before[1]
    launches = (suffix_sort.KERNEL_LAUNCHES - before[2]) + (radix.PASS_LAUNCHES - before[3])
    skipped = suffix_sort.PASSES_SKIPPED - before[4]
    # each round's lists: round 0 all n0 rotations through the passes, then
    # the record's next active and next large counts
    words = call.rows[0]["words"]
    large = [n0] + [int(w[3]) for w in words[:-1]]
    small = [0] + [int(w[0] - w[3]) for w in words[:-1]]
    ms = _cuda_ms(lambda: bwt_forward(padded, n0), 20)
    plain_ms = _cuda_ms(lambda: bwt_forward_ref(padded, n0), 5)
    # what a BWT of these bytes needs, whatever the algorithm: the block read
    # and the column and key written once, against the n log2 n compares of
    # a comparison sort of its rotations
    bound = _bound(n0 + N + 8, n0 * math.log2(n0))
    # what this formulation moves on this block: per member of a large
    # class and round, its key built (the list entry and a rank read, the
    # key written, 16 bytes; in round 0 five block bytes) and each radix
    # pass run (16 bytes); per member of a small class, its entry and two
    # ranks read and its key written (20 bytes); per active rotation, the
    # re-rank's two reads of the sorted key and its writes of rank, sa and
    # the next list (28 bytes); then the last column (sa and the block
    # read, the column written); one operation a key and pass (every pass
    # counted, the skipped ones too: the record counts them a call)
    passes = suffix_sort.call_sizes(n0)[3]
    pass_keys = sum(large) * passes
    formulation = _bound(sum(large) * 16 + pass_keys * 16 + sum(small) * 20 + active * 28
                         + 5 * n0 + N + 8, pass_keys + sum(small) * 4)
    parts = {
        "bwt_keys": _bound(sum(large) * 16, sum(large) * passes),
        "radix_pass_full_width": _bound(16 * n0, n0),
        "bwt_small_sort": _bound(sum(small) * 20, sum(small) * 4),
        "bwt_rank_tiles+bwt_rank_apply": _bound(active * 28, active),
        "bwt_last_column": _bound(5 * n0 + N + 8, N),
    }
    _say("kernel", f"bwt N={N} n={n0} kernel_ms={ms} plain_ms={plain_ms} rounds={rounds} "
            f"active_rotations_sorted={active} large_by_round={large} small_by_round={small} "
            f"radix_passes_skipped={skipped} launches_per_call={launches} calls_per_block=1 "
            f"bound_us={bound[0] * 1e3} bound_by={bound[1]} (any algorithm) "
            f"this_formulation_bound_us={formulation[0] * 1e3} "
            f"this_formulation_bound_by={formulation[1]} "
            + " ".join(f"{k}_bound_us={v[0] * 1e3}" for k, v in parts.items())
            + " (CUDA events, inputs=corpus_block0)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound}


def radix_kernels(padded, n0, rng):
    """The radix sort against its plain version on the card, exactly, and
    20 calls of it equal: random 60-bit keys at n = 900,000 and the keys of
    the corpus block's doubling rounds 0 (all 900,000 rotations), 1 and 3
    (the BWT's own keys: bits 20-59 sorted, the position below; classes of
    mixed sizes) and of the near-periodic block's round 5 (a few huge
    classes). Then on round 0's keys the
    kernel's ms, the plain version's, torch.sort's (the yardstick, never
    called by the port), the launches of one call and the bound: the keys
    read once and written once, one operation a key and pass."""
    from tpubz_torch.corpus import edge_blocks
    from tpubz_torch.kernels import radix, suffix_sort

    lo, hi = suffix_sort.KEY_LO, suffix_sort.KEY_HI
    bits = radix.library_sizes(1)[1]
    if bits != radix.DIGIT_BITS or suffix_sort.call_sizes(n0)[3] != len(radix.passes(lo, hi, bits)):
        raise AssertionError(f"the library's {bits}-bit digits are not the plain version's "
                             f"{radix.DIGIT_BITS} or not the BWT's")
    block = padded[:n0]
    near = torch.frombuffer(bytearray(edge_blocks()["near_periodic"]), dtype=torch.uint8)
    inputs = {
        "random60": torch.from_numpy(rng.integers(0, 1 << 60, n0, dtype=np.int64)).to(padded.device),
        "round0_block0": suffix_sort.round_keys(block, 0),
        "round1_block0": suffix_sort.round_keys(block, 1),
        "round3_block0": suffix_sort.round_keys(block, 3),
        "round5_near_periodic": suffix_sort.round_keys(near.to(padded.device), 5),
    }
    err = 0
    for name, keys in inputs.items():
        got = radix.radix_sort(keys, lo, hi)
        ref = radix.radix_sort_ref(keys, lo, hi, bits)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum())
        e = int((got - ref).abs().max())
        err = max(err, e)
        _say("kernel", f"radix vs plain inputs={name} n={keys.numel()} bits=[{lo},{hi}) "
                f"digit_bits={bits} mismatches={mismatches} max_abs_err={e} tolerance=0")
        if mismatches:
            raise AssertionError(f"radix_sort disagrees with its plain version on {name}")
        # the look-back's races: 19 repeats, every key equal to the first
        differing = sum(int((radix.radix_sort(keys, lo, hi) != got).sum()) for _ in range(19))
        _say("kernel", f"radix repeats inputs={name} calls=20 differing_slots={differing}")
        if differing:
            raise AssertionError(f"radix_sort gave different outputs on a repeat of {name}")
    keys = inputs["round0_block0"]
    n = keys.numel()
    before = radix.PASS_LAUNCHES
    radix.radix_sort(keys, lo, hi)
    torch.cuda.synchronize()
    launches = radix.PASS_LAUNCHES - before
    passes = len(radix.passes(lo, hi, bits))
    bound = _bound(16 * n, passes * n)
    ms = _cuda_ms(lambda: radix.radix_sort(keys, lo, hi), 20)
    plain_ms = _cuda_ms(lambda: radix.radix_sort_ref(keys, lo, hi, bits), 5)
    library_ms = _cuda_ms(lambda: torch.sort(keys), 20)
    _say("kernel", f"radix n={n} bits=[{lo},{hi}) digit_bits={bits} passes={passes} "
            f"kernel_ms={ms} plain_ms={plain_ms} torch_sort_ms={library_ms} "
            f"launches_per_call={launches} bound_us={bound[0] * 1e3} bound_by={bound[1]} "
            f"(the same order as torch.sort: the keys are unique and in position order) "
            f"(CUDA events, inputs=round0_block0)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound": bound}


def _batch_level9_rows(corpus, edges, rng, dev):
    """The batched kernels' level-9 rows: the corpus's first block, the
    near-periodic block, bytes(range(256)) * 3500 (tied rotations), random
    bytes of an odd length (a few thousand symbols >= 256, under the
    sidecar's cap) and every byte pair in order (65,282 symbols >= 256: the
    sidecar overflows). (data uint8[5, N] on dev, n, names)."""
    from tpubz_torch.block.encode import block_n
    from tpubz_torch.corpus import sidecar_overflow_block

    rows = {"corpus_block0": corpus[:LEVEL * 100_000],
            "near_periodic": edges["near_periodic"], "all256": edges["all256"],
            "random_odd": rng.bytes(899_001), "sidecar_overflow": sidecar_overflow_block()}
    data = torch.zeros(len(rows), block_n(LEVEL), dtype=torch.uint8)
    for b, row in enumerate(rows.values()):
        data[b, : len(row)] = torch.frombuffer(bytearray(row), dtype=torch.uint8)
    return data.to(dev), [len(r) for r in rows.values()], list(rows)


def batch_kernels(corpus, edges, rng):
    """The multi-process path's batched kernels (csrc/bwt.cu's batched call,
    csrc/mtf.cu and csrc/rle2.cu with the row as a grid dimension,
    csrc/compact.cu) against their plain versions on the card, exactly, on
    five level-9 rows at once (_batch_level9_rows); each row also equal to
    the one-block kernels' output for it; the compact form also at B = 1, 3
    and 4, on the rows as a view at an odd element offset, and 20 calls
    equal. Then each call's ms and the plain version's (CUDA events), its
    device µs and launches (torch.profiler, one call; the compact form must
    be one kernel) and its bound; and the batched transform's ms per block at
    B = 1, 4 and 8 corpus blocks against the one-block chain on the same
    blocks. Returns per kernel max_abs_err, ms, plain_ms and bound."""
    from tpubz_torch.block.encode import block_n
    from tpubz_torch.dist.sharded import make_sharded_transform
    from tpubz_torch.kernels import compact, mtf, rle2, suffix_sort
    from tpubz_torch.stage_probe import kernel_device_us

    dev = torch.device("cuda")
    data, n, names = _batch_level9_rows(corpus, edges, rng, dev)
    B, N = data.shape
    err = dict.fromkeys(("bwt_batch", "mtf_batch", "rle2_batch", "compact"), 0)

    def held(kernel, what, got, want):
        torch.cuda.synchronize()
        mismatches = sum(int((g.long() != w.long()).sum()) for g, w in zip(got, want))
        e = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        err[kernel] = max(err[kernel], e)
        _say("kernel", f"{kernel} vs {what} rows={','.join(names)} B={B} N={N} "
                f"mismatches={mismatches} max_abs_err={e} tolerance=0")
        if mismatches:
            raise AssertionError(f"{kernel} disagrees with {what}")

    keys, last = suffix_sort.bwt_forward_batch(data, n)
    held("bwt_batch", "plain", (keys, last), suffix_sort.bwt_forward_batch_ref(data, n))
    one = [suffix_sort.bwt_forward(data[b], n[b]) for b in range(B)]
    held("bwt_batch", "one-block bwt_forward", (keys, last),
         (torch.stack([k for k, _ in one]), torch.stack([c for _, c in one])))
    ranks, used = mtf.mtf_ranks_batch(last, n)
    rranks, rused = mtf.mtf_ranks_batch_ref(last, n)
    valid = torch.arange(N, device=dev)[None, :] < torch.tensor(n, device=dev)[:, None]
    held("mtf_batch", "plain", (ranks * valid, used), (rranks * valid, rused))
    one = [mtf.mtf_ranks(last[b], n[b]) for b in range(B)]
    held("mtf_batch", "one-block mtf_ranks", (ranks * valid, used),
         (torch.stack([r for r, _ in one]) * valid, torch.stack([u for _, u in one])))
    eob = used.sum(1, dtype=torch.int32) + 1
    syms, rle2_len, freqs = rle2.rle2_encode_batch(ranks, n, eob)
    held("rle2_batch", "plain", (syms, rle2_len, freqs), rle2.rle2_encode_batch_ref(ranks, n, eob))
    one = [rle2.rle2_encode(ranks[b], n[b], eob[b]) for b in range(B)]
    held("rle2_batch", "one-block rle2_encode", (syms, rle2_len, freqs),
         tuple(torch.stack([o[k] for o in one]) for k in range(3)))
    # the look-back's races: 19 repeats, every output equal to the first
    differing = sum(int((a.long() != b.long()).sum()) for _ in range(19)
                    for a, b in zip(rle2.rle2_encode_batch(ranks, n, eob), (syms, rle2_len, freqs)))
    _say("kernel", f"rle2_batch repeats B={B} calls=20 differing_slots={differing}")
    if differing:
        raise AssertionError("rle2_encode_batch gave different outputs on a repeat")
    got = compact.stage_compact(syms, rle2_len)
    held("compact", "plain", got, compact.stage_compact_ref(syms, rle2_len))
    for rows in (1, 3, 4):  # B = 1, 3, 4: the batch's first rows
        held("compact", f"plain B={rows}", compact.stage_compact(syms[:rows], rle2_len[:rows]),
             compact.stage_compact_ref(syms[:rows], rle2_len[:rows]))
    # the rows a view at an odd element offset: every row off a 16-byte boundary
    flat = torch.empty(B * (N + 8) + 9, dtype=torch.uint16, device=dev)
    odd = flat[1: 1 + B * (N + 8)].view(B, N + 8)
    odd.copy_(syms)
    held("compact", "plain view_at_element_offset_1", compact.stage_compact(odd, rle2_len),
         compact.stage_compact_ref(odd, rle2_len))
    # the look-back's races and the scratch's reuse: 19 repeats equal the first
    differing = sum(int((a.long() != b.long()).sum()) for _ in range(19)
                    for a, b in zip(compact.stage_compact(syms, rle2_len), got))
    _say("kernel", f"compact repeats B={B} calls=20 differing_entries={differing}")
    if differing:
        raise AssertionError("stage_compact gave different outputs on a repeat")
    hi_count = got[2].tolist()
    if max(hi_count) <= compact.HI_CAP:
        raise AssertionError(f"no row overflowed the sidecar: {hi_count}")
    _say("kernel", f"compact hi_count={dict(zip(names, hi_count))} HI_CAP={compact.HI_CAP}")

    # the same rows as the main path meets them: each rank's one row
    OUT = N + 8
    nsum = sum(n)
    timed = {
        "bwt_batch": (lambda: suffix_sort.bwt_forward_batch(data, n),
                      lambda: suffix_sort.bwt_forward_batch_ref(data, n),
                      _bound(nsum + B * (N + 8), sum(x * math.log2(x) for x in n)), 3),
        # bytes in, ranks and used maps out
        "mtf_batch": (lambda: mtf.mtf_ranks_batch(last, n), lambda: mtf.mtf_ranks_batch_ref(last, n),
                      _bound(B * (N + 4 * N + 256 + 4), B * N), 20),
        # ranks and the EOBs in; uint16 symbols, int32 lengths and frequencies out
        "rle2_batch": (lambda: rle2.rle2_encode_batch(ranks, n, eob),
                       lambda: rle2.rle2_encode_batch_ref(ranks, n, eob),
                       _bound(B * (4 * N + 8 + 2 * OUT + 4 + 4 * 258), B * N), 20),
        # symbols and lengths in; bytes, sidecars and counts out
        "compact": (lambda: compact.stage_compact(syms, rle2_len),
                    lambda: compact.stage_compact_ref(syms, rle2_len),
                    _bound(B * (2 * OUT + 4 + OUT + 4 * compact.HI_CAP + 4), B * OUT), 20),
    }
    result = {}
    for name, (run, plain, bound, reps) in timed.items():
        before = (rle2.BATCH_LAUNCHES, rle2.BATCH_KERNEL_LAUNCHES)
        ms, plain_ms = _cuda_ms(run, reps), _cuda_ms(plain, 2)
        extra = ""
        if name == "rle2_batch":  # every call of _cuda_ms's run counted
            per_call = ((rle2.BATCH_KERNEL_LAUNCHES - before[1])
                        // max(rle2.BATCH_LAUNCHES - before[0], 1))
            extra = f"kernels_per_call={per_call} (the wrapper's count) "
        prof = _one_launch(run, "compact_rows", name) if name == "compact" else kernel_device_us(run)
        result[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms, "bound": bound,
                        "device_us": prof["sum_us"]}
        _say("kernel", f"{name} B={B} N={N} kernel_ms={ms} plain_ms={plain_ms} "
                f"device_us={prof['sum_us']} device_launches={prof['launches']} "
                f"bound_us={bound[0] * 1e3} bound_by={bound[1]} {extra}"
                f"(CUDA events; device time from torch.profiler, one call; inputs={','.join(names)})")

    # the batched transform at B = 1, 4, 8 corpus blocks against the
    # one-block chain (bwt_forward, mtf_ranks, rle2_encode) on the same blocks
    N9, n0 = block_n(LEVEL), LEVEL * 100_000
    transform = make_sharded_transform(dev, N9)
    blocks = torch.zeros(8, N9, dtype=torch.uint8)
    for b in range(8):
        blk = corpus[b * n0: (b + 1) * n0]
        blocks[b, : len(blk)] = torch.frombuffer(bytearray(blk), dtype=torch.uint8)
    blocks = blocks.to(dev)

    def chain(rows):
        for b in range(rows):
            _, col = suffix_sort.bwt_forward(blocks[b], n0)
            r, u = mtf.mtf_ranks(col, n0)
            rle2.rle2_encode(r, n0, u.sum() + 1)

    sizes = {}
    for rows in (1, 4, 8):
        batched = _cuda_ms(lambda: transform(blocks[:rows], [n0] * rows), 5)
        single = _cuda_ms(lambda: chain(rows), 5)
        sizes[rows] = (batched / rows, single / rows)
    _say("kernel", "sharded_transform ms_per_block " + " ".join(
        f"B={rows}:batched={b},one_block_chain={o}" for rows, (b, o) in sizes.items())
        + " (CUDA events, corpus blocks 0-7, the batched chain with the compact form)")
    return result

def _devrefine_inputs(enc, blk):
    """A level-9 block's transform on the card and what the device refine
    encoder fetches of it: (trans_out, rle2_len, freqs, used, alpha)."""
    out = enc.transform(np.frombuffer(blk, np.uint8))
    _, _, rle2_len, freqs, used = enc.fetch(out)
    return out, rle2_len, freqs, used, int(used.sum()) + 2


def _final_tables(enc, out, rle2_len, freqs, alpha):
    """The device refinement's final tables of a block as the encoder hands
    them to pack_payload: (sel, codes, lens on the card, the payload's bits,
    passes)."""
    from tpubz_torch.block.encode import payload_tables
    from tpubz_torch.hostref.huffman import canonical_codes

    sel, lens, rfreq, tc, passes = enc.devrefine_tables(out[1], out[2], rle2_len, freqs, alpha)
    codes = np.stack([canonical_codes(lens[t, :alpha]) for t in range(tc)])
    tables = payload_tables(sel, codes, lens, tc, alpha, out[1].shape[0], out[1].device)
    return (*tables, int((rfreq[:tc, :alpha] * lens[:tc, :alpha]).sum()), passes)


def devrefine_kernels(corpus, edges):
    """The device refine kernels against their plain versions on the card,
    exactly (whole arrays: pad rows, pad words and totals included):
    chunk_hist on the transforms of the corpus's first level-9 block, the
    three edge blocks and the sidecar overflow block (symbols >= 256);
    chunk_hist_batch on _batch_level9_rows' five rows through the batched
    transform; refine_pass over those blocks' symbols (uint16 with the
    device length, and int32 with a host int) with C bzip2's initial tables
    for each table count 2..6, and once with two identical tables (a forced
    tie), and over each of the five batch rows (a view into the [B, OUT]
    symbols); pack_bits on 2^20 seeded fields of 0 to 24 bits (also into
    more words than its tiles reach, and as views at odd element offsets);
    pack_payload on the blocks' final tables, its total equal to the
    refinement's count, again with int32 symbols and a host length, on the
    corpus block at stream lengths around a tile, and on each batch row
    with seeded tables.
    Then on the corpus block (the five rows for the batch, the 2^20 fields
    for pack_bits) each call's ms and the plain version's (CUDA events;
    refine_pass as the encoder calls it: its block's RefinePasses.launch),
    its device µs and launches (torch.profiler, one call; refine_pass,
    pack_bits and pack_payload must each be one kernel), torch.bincount's ms on the flat index for the
    histograms, and the bound (refine_pass's also in the histogram's
    formulation). Returns per kernel max_abs_err, ms, plain_ms,
    library_ms, bound."""
    from tpubz_torch.block.encode import DeviceBlockEncoder, block_n
    from tpubz_torch.corpus import sidecar_overflow_block
    from tpubz_torch.dist.sharded import make_sharded_transform
    from tpubz_torch.hostref.huffman import c_init_tables
    from tpubz_torch.kernels import bitpack, huffman_dev as H
    from tpubz_torch.stage_probe import kernel_device_us

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 9)
    enc = DeviceBlockEncoder(LEVEL)
    blocks = {"corpus_block0": corpus[:LEVEL * 100_000], **edges,
              "sidecar_overflow": sidecar_overflow_block()}
    names = ",".join(blocks)
    err = dict.fromkeys(("chunk_hist", "chunk_hist_batch", "refine_pass", "pack_bits",
                         "pack_payload"), 0)

    def held(kernel, inputs, got, want):
        torch.cuda.synchronize()
        mismatches = sum(int((g.long() != w.long()).sum()) for g, w in zip(got, want))
        e = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        err[kernel] = max(err[kernel], e)
        _say("kernel", f"{kernel} vs plain inputs={inputs} mismatches={mismatches} "
                f"max_abs_err={e} tolerance=0")
        if mismatches:
            raise AssertionError(f"{kernel} disagrees with its plain version on {inputs}")

    inputs = {}
    for name, blk in blocks.items():
        out, rl, freqs, used, alpha = _devrefine_inputs(enc, blk)
        syms, rl_d = out[1], out[2]
        hist = H.chunk_hist(syms, rl_d)
        held("chunk_hist", f"{name} rle2_len={rl} OUT={syms.shape[0]}", (hist,),
             (H.chunk_hist_ref(syms, rl_d),))
        for tc in range(2, 7):
            lens = torch.from_numpy(c_init_tables(freqs, tc, alpha).astype(np.int32)).to(dev)
            want = H.refine_pass_ref(syms, rl_d, lens, tc)
            held("refine_pass", f"{name} c_init_tables table_count={tc}",
                 H.refine_pass(syms, rl_d, lens, tc), want)
            held("refine_pass", f"{name} int32_symbols host_length table_count={tc}",
                 H.refine_pass(syms.int(), rl, lens, tc), want)
        lens = c_init_tables(freqs, 6, alpha).astype(np.int32)
        lens[4] = lens[2]  # two identical tables: their groups take table 2
        lens = torch.from_numpy(lens).to(dev)
        held("refine_pass", f"{name} tables_2_and_4_equal table_count=6",
             H.refine_pass(syms, rl_d, lens, 6), H.refine_pass_ref(syms, rl_d, lens, 6))
        sel, codes, lens, bits, passes = _final_tables(enc, out, rl, freqs, alpha)
        words, total = H.pack_payload(syms, rl_d, sel, codes, lens)
        held("pack_payload", f"{name} final_tables passes={passes} payload_bits={bits}",
             (words, total), H.pack_payload_ref(syms, rl_d, sel, codes, lens))
        if int(total) != bits:
            raise AssertionError(f"pack_payload on {name}: {int(total)} bits, refinement {bits}")
        held("pack_payload", f"{name} int32_symbols host_length", H.pack_payload(
            syms.int(), rl, sel, codes, lens), H.pack_payload_ref(syms.int(), rl, sel, codes, lens))
        inputs[name] = (syms, rl_d, rl, hist, freqs, alpha, (sel, codes, lens, bits))
    syms0, _, _, _, _, _, tables0 = inputs["corpus_block0"]
    for length in (0, 1, 4095, 4096, 4097, syms0.shape[0]):  # around a tile, and every lane
        held("pack_payload", f"corpus_block0 rle2_len={length}",
             H.pack_payload(syms0, length, *tables0[:3]),
             H.pack_payload_ref(syms0, length, *tables0[:3]))

    data, n, row_names = _batch_level9_rows(corpus, edges, rng, dev)
    B, N = data.shape
    rows = make_sharded_transform(dev, N)(data, n)
    bsyms, blens = rows[1], rows[2]
    bhist = H.chunk_hist_batch(bsyms, blens)
    held("chunk_hist_batch", f"{','.join(row_names)} B={B}", (bhist,),
         (H.chunk_hist_batch_ref(bsyms, blens),))
    one = torch.stack([H.chunk_hist(bsyms[b], blens[b]) for b in range(B)])
    held("chunk_hist_batch", "one-block chunk_hist row by row", (bhist,), (one,))
    blens6 = np.random.default_rng(SEED + 13).integers(1, 18, (6, 258)).astype(np.int32)
    blens6 = torch.from_numpy(blens6).to(dev)
    bcodes = torch.from_numpy((np.random.default_rng(SEED + 14).integers(0, 1 << 17, (6, 258))
                               & ((1 << blens6.cpu().numpy()) - 1)).astype(np.int32)).to(dev)
    bsel = torch.from_numpy(np.random.default_rng(SEED + 15).integers(
        0, 6, H.nsel_cap(N + 8)).astype(np.int8)).to(dev)
    for b in range(B):
        held("refine_pass", f"batch_row_view {row_names[b]} table_count=5",
             H.refine_pass(bsyms[b], blens[b], blens6, 5),
             H.refine_pass_ref(bsyms[b], blens[b], blens6, 5))
        held("pack_payload", f"batch_row_view {row_names[b]} seeded_tables",
             H.pack_payload(bsyms[b], blens[b], bsel, bcodes, blens6),
             H.pack_payload_ref(bsyms[b], blens[b], bsel, bcodes, blens6))

    m = 1 << 20
    fbits = rng.integers(0, 25, m).astype(np.int32)
    fvals = (rng.integers(0, 1 << 24, m) & ((1 << fbits) - 1)).astype(np.uint32)
    fvals[fbits == 24] |= 1 << 23  # every 24-bit field has its top bit set
    vals = torch.from_numpy(fvals.view(np.int32)).to(dev)
    fb = torch.from_numpy(fbits).to(dev)
    cap = (int(fbits.sum()) + 31) // 32 + 1
    held("pack_bits", f"seeded_fields_0_to_24_bits n={m} total_bits={int(fbits.sum())}",
         bitpack.pack_bits_device(vals, fb, cap), bitpack.pack_bits_device_ref(vals, fb, cap))
    wide = (m // 4096 + 2) * 4096 + 4099  # words past every tile's lanes
    held("pack_bits", f"seeded_fields out_words={wide}", bitpack.pack_bits_device(vals, fb, wide),
         bitpack.pack_bits_device_ref(vals, fb, wide))
    vbuf = torch.zeros(m + 8, dtype=torch.int32, device=dev)
    bbuf = torch.zeros(m + 8, dtype=torch.int32, device=dev)
    ov, ob = vbuf[1: 1 + m], bbuf[3: 3 + m]  # each its own alignment
    ov.copy_(vals)
    ob.copy_(fb)
    held("pack_bits", "seeded_fields views_at_element_offsets_1_and_3",
         bitpack.pack_bits_device(ov, ob, cap), bitpack.pack_bits_device_ref(ov, ob, cap))

    syms, rl_d, rl, hist, freqs, alpha, (sel, codes, lens, bits) = inputs["corpus_block0"]
    OUT = syms.shape[0]
    nsel = H.nsel_cap(OUT)
    lens6 = torch.from_numpy(c_init_tables(freqs, 6, alpha).astype(np.int32)).to(dev)
    idx = torch.arange(OUT, dtype=torch.int64, device=dev)
    flat = (idx // 50 * 258 + syms.to(torch.int64))[idx < rl_d]
    sym_bytes = syms.element_size()  # the one-block symbols are uint16
    bidx = torch.arange(N + 8, dtype=torch.int64, device=dev)[None, :]
    bflat = ((torch.arange(B, device=dev)[:, None] * nsel + bidx // 50) * 258
             + bsyms.to(torch.int64))[bidx < blens[:, None]]
    hist_bytes = nsel * 258 * 4
    words_out = H.payload_words_cap(OUT) * 4 + 8
    passes = H.RefinePasses(syms, rl_d)
    passes.lens.copy_(lens6)
    tables_bytes = 2 * 6 * 258 * 4  # the lengths in, the frequencies out
    timed = {
        # symbols of the stream in, the whole histogram out
        "chunk_hist": (lambda: H.chunk_hist(syms, rl_d), lambda: H.chunk_hist_ref(syms, rl_d),
                       lambda: torch.bincount(flat, minlength=nsel * 258),
                       _bound(sym_bytes * rl + 8 + hist_bytes, rl), 20, f"corpus_block0 OUT={OUT}"),
        "chunk_hist_batch": (lambda: H.chunk_hist_batch(bsyms, blens),
                             lambda: H.chunk_hist_batch_ref(bsyms, blens),
                             lambda: torch.bincount(bflat, minlength=B * nsel * 258),
                             _bound(2 * int(blens.sum()) + 4 * B + B * hist_bytes,
                                    int(blens.sum())), 20, f"{','.join(row_names)} B={B}"),
        # the symbols of the stream and the lengths in; selectors and
        # frequencies out; six length gathers and adds and one count a symbol
        "refine_pass": (lambda: passes.launch(6),
                        lambda: H.refine_pass_ref(syms, rl_d, lens6, 6), None,
                        _bound(sym_bytes * rl + 8 + tables_bytes + nsel, 7 * rl), 20,
                        "corpus_block0 c_init_tables table_count=6 (the encoder's form: its "
                        "block's RefinePasses.launch)"),
        # values and lengths in, the words and the total out
        "pack_bits": (lambda: bitpack.pack_bits_device(vals, fb, cap),
                      lambda: bitpack.pack_bits_device_ref(vals, fb, cap), None,
                      _bound(8 * m + 4 * cap + 8, m), 20, f"seeded_fields n={m}"),
        # symbols of the stream, selectors and tables in; the words out
        "pack_payload": (lambda: H.pack_payload(syms, rl_d, sel, codes, lens),
                         lambda: H.pack_payload_ref(syms, rl_d, sel, codes, lens), None,
                         _bound(sym_bytes * rl + 8 + nsel + 2 * 6 * 258 * 4 + words_out, rl), 20,
                         f"corpus_block0 final_tables payload_bits={bits}"),
    }
    result = {}
    for name, (run, plain, library, bound, reps, what) in timed.items():
        ms, plain_ms = _cuda_ms(run, reps), _cuda_ms(plain, 3)
        library_ms = _cuda_ms(library, reps) if library else None
        if name in ("pack_bits", "pack_payload"):
            prof = _one_launch(run, "pack_tiles", name)
        else:
            prof = kernel_device_us(run)
        result[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound": bound, "device_us": prof["sum_us"]}
        extra = ""
        if name == "refine_pass":
            if prof["launches"] != 1 or not all("refine_symbols" in k for k in prof["kernels_us"]):
                raise AssertionError(f"a refinement pass ran {prof['kernels_launches']} on the card")
            # the histogram's formulation: the 18.6 MB histogram read a pass,
            # a multiply and an add per count and table
            old = _bound(hist_bytes + tables_bytes + nsel, 2 * 6 * 258 * nsel)
            extra = f"histogram_formulation_bound_us={old[0] * 1e3} bound_by={old[1]} "
        _say("kernel", f"{name} kernel_ms={ms} plain_ms={plain_ms} "
                + (f"torch_bincount_ms={library_ms} " if library else "")
                + f"device_us={prof['sum_us']} device_launches={prof['launches']} "
                f"bound_us={bound[0] * 1e3} bound_by={bound[1]} {extra}(CUDA events; device "
                f"time from torch.profiler, one call; inputs={what})")
    return result


def lean_ibwt_kernels(padded, n0, edges):
    """The lean form's kernel (rle2_compact) and the inverse BWT's
    (next_pointers, bwt_inverse_device) against their plain versions on the
    card, exactly (every lane of every output). rle2_compact on the MTF
    ranks of the corpus's first level-9 block, the three edge blocks and
    the sidecar overflow block (65,282 symbols 256, over HI_CAP), and on
    random ranks with zero runs up to 70,000 long and all 256 bytes used
    (EOB 257); the inverse on those blocks' BWT, each also equal to the
    block itself, on the corpus block's column with 96 pad lanes past a
    shorter n, and on n = 0, 1 and 2. Then on the corpus block each call's
    ms and the plain version's (CUDA events), its device µs and launches
    (torch.profiler, one call), torch.sort(stable=True)'s ms beside the
    next pointers, and the bounds. Returns per kernel max_abs_err, ms,
    plain_ms, library_ms, bound."""
    from tpubz_torch.corpus import sidecar_overflow_block
    from tpubz_torch.kernels import compact, ibwt, mtf
    from tpubz_torch.kernels.suffix_sort import bwt_forward
    from tpubz_torch.stage_probe import kernel_device_us

    dev, N = padded.device, padded.shape[0]
    blocks = {"corpus_block0": (padded, n0)}
    for name, blk in list(edges.items()) + [("sidecar_overflow", sidecar_overflow_block())]:
        data = torch.zeros(N, dtype=torch.uint8, device=dev)
        data[: len(blk)] = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(dev)
        blocks[name] = (data, len(blk))
    err = dict.fromkeys(("rle2_compact", "next_pointers", "bwt_inverse"), 0)

    def held(kernel, inputs, got, want):
        torch.cuda.synchronize()
        mismatches = sum(int((g.long() != w.long()).sum()) for g, w in zip(got, want))
        e = max((int((g.long() - w.long()).abs().max()) for g, w in zip(got, want) if g.numel()),
                default=0)
        err[kernel] = max(err[kernel], e)
        _say("kernel", f"{kernel} vs plain inputs={inputs} mismatches={mismatches} "
                f"max_abs_err={e} tolerance=0")
        if mismatches or any(g.shape != w.shape for g, w in zip(got, want)):
            raise AssertionError(f"{kernel} disagrees with its plain version on {inputs}")

    columns = {}
    for name, (data, n) in blocks.items():
        key, last = bwt_forward(data, n)
        ranks, used = mtf.mtf_ranks(last, n)
        got = compact.rle2_compact(ranks, n, used)
        hc = int(got[3])
        held("rle2_compact", f"{name} n={n} hi_count={hc}", got,
             compact.rle2_compact_ref(ranks, n, used))
        if name == "sidecar_overflow" and hc <= compact.HI_CAP:
            raise AssertionError(f"the sidecar overflow block has {hc} symbols 256")
        columns[name] = (int(key), last, n, data[:n])
    runs = np.zeros(N, np.int32)
    rng = np.random.default_rng(SEED + 10)
    at = int(rng.integers(0, 100))
    while at < N:
        runs[at] = rng.integers(1, 256)
        at += 1 + int(rng.choice([0, 1, 3, 30, 700, 5000, 70_000]))
    runs[:255] = np.arange(1, 256)  # rank 255 near the start
    all_used = torch.ones(256, dtype=torch.bool, device=dev)
    r = torch.from_numpy(runs).to(dev)
    got = compact.rle2_compact(r, N - 1000, all_used)
    held("rle2_compact", f"random_zero_runs eob=257 hi_count={int(got[3])}", got,
         compact.rle2_compact_ref(r, N - 1000, all_used))
    # the look-back's races: 19 repeats, every output equal to the first
    differing = sum(int((a.long() != b.long()).sum()) for _ in range(19)
                    for a, b in zip(compact.rle2_compact(r, N - 1000, all_used), got))
    _say("kernel", f"rle2_compact repeats inputs=random_zero_runs calls=20 "
            f"differing_slots={differing}")
    if differing:
        raise AssertionError("rle2_compact gave different outputs on a repeat")

    for name, (key, last, n, data) in columns.items():
        held("next_pointers", f"{name} n={n} N={N}", (ibwt.next_pointers(last, n),),
             (ibwt.next_pointers_ref(last, n),))
        out = ibwt.bwt_inverse_device(key, last, n)
        held("bwt_inverse", f"{name} n={n} key={key}", (out,),
             (ibwt.bwt_inverse_device_ref(key, last, n),))
        if not torch.equal(out, data):
            raise AssertionError(f"bwt_inverse_device did not give {name} back")
    key, last, n, data = columns["corpus_block0"]
    short = 800_000  # the column of a shorter block: 100,096 pad lanes
    skey, slast = bwt_forward(data[:short], short)
    spad = torch.zeros(N, dtype=torch.uint8, device=dev)
    spad[:short] = slast
    held("next_pointers", f"corpus_prefix n={short} N={N}", (ibwt.next_pointers(spad, short),),
         (ibwt.next_pointers_ref(spad, short),))
    out = ibwt.bwt_inverse_device(int(skey), spad, short)
    held("bwt_inverse", f"corpus_prefix n={short} N={N}", (out,),
         (ibwt.bwt_inverse_device_ref(int(skey), spad, short),))
    if not torch.equal(out, data[:short]):
        raise AssertionError("bwt_inverse_device did not give the corpus prefix back")
    for tiny in (b"", b"x", b"xy"):
        t = torch.zeros(16, dtype=torch.uint8, device=dev)
        t[: len(tiny)] = torch.tensor(list(tiny), dtype=torch.uint8, device=dev)
        tkey, tlast = bwt_forward(t, len(tiny))
        held("next_pointers", f"n={len(tiny)} N=16", (ibwt.next_pointers(tlast, len(tiny)),),
             (ibwt.next_pointers_ref(tlast, len(tiny)),))
        out = ibwt.bwt_inverse_device(int(tkey), tlast, len(tiny))
        if bytes(out.cpu().numpy()) != tiny:
            raise AssertionError(f"bwt_inverse_device did not give {tiny!r} back")

    ibwt.finish_calls()
    ibwt.bwt_inverse_device(key, last, n)
    (record,) = ibwt.finish_calls()  # the corpus block's walks, as the card counted them
    ranks, used = mtf.mtf_ranks(last, n)
    OUT = N + 8
    idx = torch.arange(N, device=dev)
    sym = torch.where(idx < n, last.to(torch.int32), 256)
    timed = {
        # ranks and the used map in; uint16 symbols, bytes, length, slots,
        # count out
        "rle2_compact": (lambda: compact.rle2_compact(ranks, n, used),
                         lambda: compact.rle2_compact_ref(ranks, n, used), None,
                         _bound(4 * N + 256 + 2 * OUT + OUT + 8 + 4 * compact.HI_CAP + 4, N)),
        # the column in, the pointers out; one operation a position
        "next_pointers": (lambda: ibwt.next_pointers(last, n),
                          lambda: ibwt.next_pointers_ref(last, n),
                          lambda: torch.sort(sym, stable=True).indices,
                          _bound(n + 4 * N, N)),
        # the column and the key in, the block out; one gather a byte
        "bwt_inverse": (lambda: ibwt.bwt_inverse_device(key, last, n),
                        lambda: ibwt.bwt_inverse_device_ref(key, last, n), None,
                        _bound(n + 8 + n, n)),
    }
    result = {}
    for name, (run, plain, library, bound) in timed.items():
        before = (compact.LEAN_LAUNCHES, compact.LEAN_KERNEL_LAUNCHES)
        ms, plain_ms = _cuda_ms(run, 20), _cuda_ms(plain, 3)
        library_ms = _cuda_ms(library, 20) if library else None
        prof = kernel_device_us(run)
        result[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound": bound, "device_us": prof["sum_us"]}
        extra = ""
        if name == "rle2_compact":
            per_call = ((compact.LEAN_KERNEL_LAUNCHES - before[1])
                        // max(compact.LEAN_LAUNCHES - before[0], 1))
            extra = f"kernels_per_call={per_call} (the wrapper's count) "
        if name == "bwt_inverse":
            # this formulation's HBM bytes, each array once, as if none of
            # it stayed in the L2: the column read, the keys written, the
            # pass's read and write, the sorted keys gathered by the walks,
            # the kept bytes written and read, the output written; the
            # level-1 nodes, records and resume rows, the level-2 nodes and
            # offsets written and read
            if prof["launches"] > 8:
                raise AssertionError(f"an inverse call made {prof['launches']} launches on the card")
            m1, m2 = record["splitters"], record["list_splitters"]
            form = _bound(n + 8 * n + 16 * n + 8 * n + 2 * n + n + 36 * m1 + 24 * m2, 8 * n)
            extra = (f"this_formulation_hbm_bound_us={form[0] * 1e3} log2_windows="
                     f"{ibwt.sizes()['log_d']} splitters={record['splitters']} "
                     f"mean_segment={n / max(record['splitters'], 1)} "
                     f"longest_segment={record['longest']} "
                     f"level2_splitters={record['list_splitters']} "
                     f"longest_level2_walk={record['list_longest']} "
                     f"top_splitters={record['top_splitters']} orbit={record['orbit']} "
                     f"(its ~20 MB of arrays fit in the 50 MB L2; the walks are chains of "
                     f"dependent L2 loads) ")
        _say("kernel", f"{name} N={N} n={n} kernel_ms={ms} plain_ms={plain_ms} "
                + (f"torch_sort_stable_ms={library_ms} " if library else "")
                + f"device_us={prof['sum_us']} device_busy_us={prof['busy_us']} "
                f"device_launches={prof['launches']} "
                f"bound_us={bound[0] * 1e3} bound_by={bound[1]} {extra}(CUDA events; device "
                f"time from torch.profiler, one call; inputs=corpus_block0)")
    return result


class _PlainCalls:
    """Counts the calls of the named plain versions while it is entered
    (by default the device refine kernels'): each wrapper reaches its plain
    version through its module, so the counting stand-in sees every call."""

    def __init__(self, targets=None):
        from tpubz_torch.kernels import bitpack, huffman_dev

        if targets is None:
            targets = [(huffman_dev, n) for n in ("chunk_hist_ref", "chunk_hist_batch_ref",
                                                  "refine_pass_ref", "pack_payload_ref")]
            targets.append((bitpack, "pack_bits_device_ref"))
        self.targets = targets
        self.calls = {n: 0 for _, n in self.targets}

    def __enter__(self):
        self.saved = [getattr(mod, n) for mod, n in self.targets]
        for (mod, n), fn in zip(self.targets, self.saved):
            def counted(*a, _fn=fn, _n=n, **k):
                self.calls[_n] += 1
                return _fn(*a, **k)
            setattr(mod, n, counted)
        return self

    def __exit__(self, *exc):
        for (mod, n), fn in zip(self.targets, self.saved):
            setattr(mod, n, fn)


def _level_blocks(data):
    """The level-9 RLE1 blocks of data with their CRCs, as compress cuts
    them: [(block uint8[n], crc)]."""
    from tpubz_torch.format.constants import block_budget
    from tpubz_torch.format.crc import block_crc
    from tpubz_torch.hostref.rle1 import rle1_blocks

    arr = np.frombuffer(data, np.uint8)
    out, cuts = rle1_blocks(arr, block_budget(LEVEL))
    return [(out[o0:o1], block_crc(arr[i0:i1])) for o0, o1, i0, i1 in cuts]


def _splice(blocks, accs):
    """The stream of the blocks' packed bits: the header, the blocks, the
    footer with the folded CRC, as stream/api.py's _compress_impl splices
    them."""
    from tpubz_torch.format.constants import FOOTER_MAGIC, STREAM_MAGIC
    from tpubz_torch.format.crc import stream_crc_fold
    from tpubz_torch.hostref.bitio import BitAccum, IncrementalSplicer

    header = BitAccum()
    for b in STREAM_MAGIC:
        header.put(b, 8)
    header.put(0x30 + LEVEL, 8)
    splicer = IncrementalSplicer(cap_hint=sum(blk.size for blk, _ in blocks) // 2 + 64)
    splicer.add(*header.pack())
    s_crc = 0
    for (_, crc), acc in zip(blocks, accs):
        s_crc = stream_crc_fold(s_crc, crc)
        splicer.add(*acc.pack())
    footer = BitAccum()
    footer.put(FOOTER_MAGIC, 48)
    footer.put(s_crc, 32)
    splicer.add(*footer.pack())
    return splicer.finish()[0]


def lean(tpubz_torch, data, stream):
    """The lean chain on [path]'s blocks and the sidecar overflow block, its
    counts read from zero: each block's fetch of transform(blk, lean=True)
    must equal the fetch of the int16 form field by field (the overflow
    block takes the full-row fetch: its symbols 256 exceed HI_CAP); then
    encode_block, which takes the lean chain, on [path]'s blocks, spliced,
    must equal [path]'s stream and round-trip through tpubz_torch.decompress
    and bunzip2. rle2_compact must have launched once a lean transform and
    no plain version run. Host ms a block of each form's fetch (the
    transform drained first). Returns the launches."""
    from tpubz_torch.block.encode import DeviceBlockEncoder
    from tpubz_torch.corpus import sidecar_overflow_block
    from tpubz_torch.kernels import compact

    blocks = _level_blocks(data)
    overflow = np.frombuffer(sidecar_overflow_block(), np.uint8)
    enc = DeviceBlockEncoder(LEVEL)
    compact.LEAN_LAUNCHES = 0
    torch.cuda.synchronize()
    fetch_ms = {"int16": [], "lean": []}
    with _PlainCalls([(compact, "rle2_compact_ref")]) as plain:
        for blk in [b for b, _ in blocks] + [overflow]:
            got = {}
            for form, is_lean in (("int16", False), ("lean", True)):
                out = enc.transform(blk, lean=is_lean)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got[form] = enc.fetch(out)
                fetch_ms[form].append((time.perf_counter() - t1) * 1e3)
            a, b = got["int16"], got["lean"]
            same = (a[0] == b[0] and a[2] == b[2] and np.array_equal(a[1], b[1])
                    and a[1].dtype == b[1].dtype and np.array_equal(a[3], b[3])
                    and np.array_equal(a[4], b[4]))
            if not same:
                raise AssertionError(f"the lean fetch of a {blk.size}-byte block differs from "
                                     f"the int16 fetch")
        transforms = compact.LEAN_LAUNCHES
        t0 = time.perf_counter()
        got = _splice(blocks, [enc.encode_block(blk, crc) for blk, crc in blocks])
        encode_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    n = len(blocks)
    if got != stream:
        raise AssertionError("the stream of lean encode_block differs from [path]'s")
    if tpubz_torch.decompress(got) != data:
        raise AssertionError("tpubz_torch.decompress round trip of the lean stream failed")
    ran = ["tpubz_torch.decompress"] + ["bunzip2"] * _bunzip2_ok(got, data)
    if transforms != n + 1 or compact.LEAN_LAUNCHES != 2 * n + 1 or any(plain.calls.values()):
        raise AssertionError(f"rle2_compact launches {transforms} and {compact.LEAN_LAUNCHES} "
                             f"for {n} + 1 blocks, plain calls {plain.calls}")
    med = {k: float(np.median(v[:n])) for k, v in fetch_ms.items()}
    _say("lean", f"blocks={n}+sidecar_overflow fetch_lean==fetch_int16 stream==path_stream "
         f"round_trips={'+'.join(ran)} rle2_compact_launches={compact.LEAN_LAUNCHES} "
         f"plain_calls={plain.calls} fetch_host_ms_per_block_median={med} "
         f"fetch_host_ms_overflow_block={{'int16': {fetch_ms['int16'][-1]}, "
         f"'lean': {fetch_ms['lean'][-1]}}} encode_block_seconds={encode_s} (host clock; "
         f"fetch from the drained transform to the host tuple; encode_block one block at a "
         f"time on this thread)")
    return {"rle2_compact": compact.LEAN_LAUNCHES}


def inverse(tpubz_torch, data, stream):
    """The inverse BWT on the card on [path]'s blocks, its counts read from
    zero: each block's (key, last column) from transform_bwt, then
    bwt_inverse_device, which must give the RLE1 block back; every call
    must have run the next pointers and, by its record as the card counted
    it, the orbit's three kernels, with L the length of p_0's cycle (a
    divisor of n: n itself unless the block is periodic) and segments among
    its walks; no plain version may run. Its ms a block (CUDA events around
    the call) beside tpubz_torch.decompress's ms a block on [path]'s stream
    (host clock), and the walks' lengths. Returns the launches."""
    from tpubz_torch.block.encode import DeviceBlockEncoder
    from tpubz_torch.kernels import ibwt

    blocks = _level_blocks(data)
    enc = DeviceBlockEncoder(LEVEL)
    ibwt.finish_calls()
    ibwt.NEXT_LAUNCHES = ibwt.INVERSE_LAUNCHES = ibwt.KERNEL_LAUNCHES = 0
    orbit_kernels = ibwt.sizes()["orbit_kernels"]
    torch.cuda.synchronize()
    ms, records = [], []
    with _PlainCalls([(ibwt, "next_pointers_ref"), (ibwt, "bwt_inverse_device_ref")]) as plain:
        for blk, _ in blocks:
            key, last, n = enc.transform_bwt(blk)
            key = int(key)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = ibwt.bwt_inverse_device(key, last, n)
            stop.record()
            stop.synchronize()
            ms.append(start.elapsed_time(stop))
            (rec,) = ibwt.finish_calls()
            records.append(rec)
            if not np.array_equal(out.cpu().numpy(), blk):
                raise AssertionError(f"bwt_inverse_device did not give a {n}-byte block back")
            if (rec["n"] != n or rec["launches"] != orbit_kernels or n % rec["orbit"]
                    or not 1 <= rec["segments"] <= rec["splitters"]
                    or rec["longest"] * rec["segments"] < rec["orbit"]):
                raise AssertionError(f"the inverse of a {n}-byte block counted {rec}")
    launches = {"next_pointers": ibwt.NEXT_LAUNCHES, "bwt_inverse": ibwt.INVERSE_LAUNCHES}
    nb = len(blocks)
    if (launches["next_pointers"] != nb or launches["bwt_inverse"] != nb
            or ibwt.KERNEL_LAUNCHES != orbit_kernels * nb or any(plain.calls.values())):
        raise AssertionError(f"inverse launches {launches}, {ibwt.KERNEL_LAUNCHES} orbit kernels "
                             f"on the card for {nb} blocks, plain calls {plain.calls}")
    t0 = time.perf_counter()
    if tpubz_torch.decompress(stream) != data:
        raise AssertionError("tpubz_torch.decompress failed")
    dec_ms = (time.perf_counter() - t0) * 1e3 / nb
    periodic = sum(r["orbit"] < r["n"] for r in records)
    _say("ibwt", f"blocks={nb} inverse==rle1_block launches={launches} "
         f"orbit_kernels_on_card={ibwt.KERNEL_LAUNCHES} plain_calls={plain.calls} "
         f"inverse_ms_per_block_median={float(np.median(ms))} "
         f"inverse_ms_per_block_range=[{min(ms)},{max(ms)}] "
         f"decompress_ms_per_block={dec_ms} log2_windows={ibwt.sizes()['log_d']} "
         f"periodic_blocks={periodic} "
         f"mean_segment_median={float(np.median([r['n'] / r['splitters'] for r in records]))} "
         f"longest_segment_max={max(r['longest'] for r in records)} "
         f"longest_level2_walk_max={max(r['list_longest'] for r in records)} "
         f"(inverse: CUDA events around the call, host launch included; decompress: host "
         f"clock, the whole stream over its blocks; segments in rows, level-2 walks in "
         f"level-1 segments)")
    return launches


def devrefine(tpubz_torch, data, stream):
    """The device refine encoder on [path]'s data, its counts read from zero:
    every level-9 block through DeviceBlockEncoder.transform and
    encode_block_devrefine (the refine_pass of each pass over the block's
    symbols, and pack_payload's fused packing kernel), spliced with the
    stream header, the CRC fold and the footer as stream/api.py's
    _compress_impl does; then the same blocks as rows of the batched
    transform (make_sharded_transform, up to 8 rows a call), each row
    through encode_block_devrefine with its symbols a view into the batch.
    Both streams must equal [path]'s and round-trip through
    tpubz_torch.decompress and bunzip2; every kernel of the path must have
    launched (one refine_pass a pass), the histograms (off the path) not,
    and no plain version run. Host ms a block of encode_block_devrefine (the
    transform done and waited for) against emit_block on the same fetched
    blocks, the refinement passes a block, and a pass's host µs by part
    (the encoder's devrefine_host_us). Returns the launches by kernel name."""
    from tpubz_torch.block.encode import DeviceBlockEncoder
    from tpubz_torch.dist.sharded import make_sharded_transform
    from tpubz_torch.kernels import bitpack, huffman_dev as H

    blocks = _level_blocks(data)
    enc = DeviceBlockEncoder(LEVEL)

    def splice(accs):
        return _splice(blocks, accs)

    H.HIST_LAUNCHES = H.HIST_BATCH_LAUNCHES = H.REFINE_LAUNCHES = H.PAYLOAD_LAUNCHES = 0
    bitpack.LAUNCHES = 0
    torch.cuda.synchronize()
    with _PlainCalls() as plain:
        dev_ms, emit_ms, accs = [], [], []
        t0 = time.perf_counter()
        for blk, crc in blocks:
            trans = enc.transform(blk)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            accs.append(enc.encode_block_devrefine(trans, crc))
            dev_ms.append((time.perf_counter() - t1) * 1e3)
            fetched = enc.fetch(trans)
            t1 = time.perf_counter()
            enc.emit_block(*fetched, crc)
            emit_ms.append((time.perf_counter() - t1) * 1e3)
        one_block_s = time.perf_counter() - t0
        got = splice(accs)
        passes = H.REFINE_LAUNCHES
        host_us = dict(enc.devrefine_host_us)
        transform = make_sharded_transform(torch.device("cuda"), enc.N)
        accs = []
        for lo in range(0, len(blocks), 8):
            part = blocks[lo: lo + 8]
            rows = torch.zeros(len(part), enc.N, dtype=torch.uint8)
            for b, (blk, _) in enumerate(part):
                rows[b, : blk.size] = torch.from_numpy(np.array(blk))
            keys, syms, rle2_len, freqs, used = transform(rows, [blk.size for blk, _ in part])[:5]
            for b, (_, crc) in enumerate(part):
                accs.append(enc.encode_block_devrefine(
                    (keys[b], syms[b], rle2_len[b], freqs[b], used[b]), crc))
        got_rows = splice(accs)
        torch.cuda.synchronize()
    launches = {"chunk_hist": H.HIST_LAUNCHES, "chunk_hist_batch": H.HIST_BATCH_LAUNCHES,
                "refine_pass": H.REFINE_LAUNCHES, "pack_payload": H.PAYLOAD_LAUNCHES,
                "pack_bits": bitpack.LAUNCHES}
    n = len(blocks)
    if got != stream or got_rows != stream:
        raise AssertionError("the device refine streams differ from [path]'s")
    if tpubz_torch.decompress(got) != data:
        raise AssertionError("tpubz_torch.decompress round trip of the device refine stream failed")
    ran = ["tpubz_torch.decompress"] + ["bunzip2"] * _bunzip2_ok(got, data)
    if (launches["chunk_hist"] or launches["chunk_hist_batch"]
            or launches["pack_payload"] != 2 * n or launches["pack_bits"] != 2 * n
            or passes < 4 * n or launches["refine_pass"] != 2 * passes
            or host_us["passes"] != passes):
        raise AssertionError(f"device refine launches {launches} for {n} blocks, {passes} passes")
    if any(plain.calls.values()):
        raise AssertionError(f"plain versions ran in [devrefine]: {plain.calls}")
    _say("devrefine", f"blocks={n} stream==path_stream rows_stream==path_stream "
         f"round_trips={'+'.join(ran)} launches={launches} plain_calls={plain.calls} "
         f"passes_per_block={passes / n} passes={passes} "
         f"pass_host_us_mean={ {k: host_us[k] / passes for k in ('upload', 'launch', 'fetch', 'trees')} } "
         f"devrefine_host_ms_per_block_median={float(np.median(dev_ms))} "
         f"devrefine_host_ms_per_block_range=[{min(dev_ms)},{max(dev_ms)}] "
         f"emit_block_host_ms_per_block_median={float(np.median(emit_ms))} "
         f"emit_block_host_ms_per_block_range=[{min(emit_ms)},{max(emit_ms)}] "
         f"one_block_leg_seconds={one_block_s} (host clock; devrefine from the transform's "
         f"outputs on the card to the packed block, emit_block from the fetched block; "
         f"one thread each, one after the other)")
    return launches


def stage_bwt(tpubz_torch, data, stream):
    """The bwt stage, device-only, on the main path's data: the same bytes,
    the BWT's library call on every block and no MTF or RLE2 kernel (they
    lie off this stage)."""
    from tpubz_torch.kernels import bitonic, mtf, radix, rle2, suffix_sort
    from tpubz_torch.stage_probe import DEVICE_ONLY, env

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with env(**DEVICE_ONLY["bwt"]):
        got = tpubz_torch.compress(data, LEVEL, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = dict(tpubz_torch.stream.api.last_stream_stats)
    if got != stream:
        raise AssertionError("the bwt stage's stream differs from the full stage's")
    if st["stage"] != "bwt" or st["dev_blocks"] != st["blocks"]:
        raise AssertionError(f"not a device-only bwt stream: {st}")
    n_passes = suffix_sort.call_sizes(1)[3]
    if (suffix_sort.LAUNCHES != st["blocks"]
            or not st["blocks"] <= radix.SORTS <= suffix_sort.ROUNDS_RUN
            or radix.PASS_LAUNCHES != n_passes * suffix_sort.ROUNDS_RUN
            or suffix_sort.PASSES_RUN + suffix_sort.PASSES_SKIPPED != n_passes * radix.SORTS
            or bitonic.PASS_LAUNCHES):
        raise AssertionError(f"{suffix_sort.LAUNCHES} BWT calls, {radix.SORTS} radix sorts "
                             f"({radix.PASS_LAUNCHES} pass launches, {suffix_sort.PASSES_RUN} "
                             f"run) in {suffix_sort.ROUNDS_RUN} rounds, "
                             f"{bitonic.PASS_LAUNCHES} bitonic launches for {st['blocks']} blocks")
    if mtf.LAUNCHES or rle2.LAUNCHES:
        raise AssertionError(f"{mtf.LAUNCHES} MTF and {rle2.LAUNCHES} RLE2 launches on the bwt stage")
    mb = len(data) / 1e6
    _say("stage_bwt", f"blocks={st['blocks']} stream==path_stream "
         f"bwt_launches={suffix_sort.LAUNCHES} bwt_rounds={suffix_sort.ROUNDS_RUN} "
         f"radix_sorts={radix.SORTS} radix_pass_launches={radix.PASS_LAUNCHES} "
         f"bitonic_pass_kernel_launches=0 mtf_launches=0 rle2_launches=0 MB={mb} seconds={dt} "
         f"MBps={mb / dt}")


def hybrid(tpubz_torch, data, stream, tmp):
    """The default routing (hybrid CPU pool, stage from a fresh profile) on
    the main path's data, then compress_cpu on the same data."""
    from tpubz_torch.kernels import mtf, radix, rle2, suffix_sort
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
         f"radix_sorts={radix.SORTS} "
         f"mtf_launches={mtf.LAUNCHES} rle2_launches={rle2.LAUNCHES} MB={mb} seconds={dt} "
         f"MBps={mb / dt} compress_cpu_seconds={cpu_dt} compress_cpu_MBps={mb / cpu_dt} "
         f"cpu_count={os.cpu_count()}")


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(world, job, timeout):
    """This script as ranks 0..world-1 of a gloo group on a free 127.0.0.1
    port, all on cuda:0; each rank's result from its file. A rank that fails
    or outlives the timeout fails the phase, and every rank is stopped."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (root, os.environ.get("PYTHONPATH")))))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "--world", str(world), "--port", port, "--job", job],
                              cwd=root, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE)
             for r in range(world)]
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, e) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} exited {p.returncode}: "
                                 f"{e.decode(errors='replace')[-3000:]}")
    with open(f"{job}.world{world}.json") as f:
        results = json.load(f)
    return [results[str(r)] for r in range(world)]


def rank_main(argv):
    """One rank of the [multihost] phase: brings up the gloo group,
    compresses the job's data with compress_multihost on cuda:0 twice, the
    first call cold (the process's first kernels and library loads) and the
    second with its batched kernels' counts read from zero, each timed from
    a barrier to a barrier, and, with more than one rank,
    decodes rank 0's stream with decompress_multihost and a corrupt copy of
    it, which must raise. Rank 0 writes the stream and every rank's result
    (the results are gathered to it)."""
    import argparse

    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--job", required=True)
    a = ap.parse_args(argv)
    from tpubz_torch.dist import multihost
    from tpubz_torch.kernels import compact, mtf, rle2, suffix_sort

    multihost.initialize(f"127.0.0.1:{a.port}", a.world, a.rank)
    with open(a.job + ".in", "rb") as f:
        data = f.read()
    seconds = []
    for _ in range(2):
        suffix_sort.BATCH_LAUNCHES = mtf.BATCH_LAUNCHES = rle2.BATCH_LAUNCHES = 0
        suffix_sort.LAUNCHES = mtf.LAUNCHES = rle2.LAUNCHES = compact.LAUNCHES = 0
        suffix_sort.ROUNDS_RUN = 0
        dist.barrier()
        t0 = time.perf_counter()
        stream = multihost.compress_multihost(data, LEVEL, device="cuda:0")
        torch.cuda.synchronize()
        dist.barrier()
        seconds.append(time.perf_counter() - t0)
    out = {"seconds_cold": seconds[0], "seconds": seconds[1], "stream_is_none": stream is None,
           "transport": multihost.last_multihost_stats["transport"],
           "launches": {"bwt_batch": suffix_sort.BATCH_LAUNCHES, "mtf_batch": mtf.BATCH_LAUNCHES,
                        "rle2_batch": rle2.BATCH_LAUNCHES, "compact": compact.LAUNCHES,
                        "one_block": suffix_sort.LAUNCHES + mtf.LAUNCHES + rle2.LAUNCHES},
           "bwt_rounds": suffix_sort.ROUNDS_RUN,
           "payload_bytes_sent": multihost.last_multihost_stats["payload_bytes_sent"]}
    if a.rank == 0:
        with open(f"{a.job}.world{a.world}.bz2", "wb") as f:
            f.write(stream)
    if a.world > 1:
        dist.barrier()  # rank 0's stream is on disk: every rank decodes it
        with open(f"{a.job}.world{a.world}.bz2", "rb") as f:
            stream = f.read()
        raw = multihost.decompress_multihost(stream)
        out["decoded_equal"] = raw is None if a.rank else raw == data
        bad = bytearray(stream)
        bad[len(bad) // 2] ^= 0x40
        t1 = time.perf_counter()
        try:
            multihost.decompress_multihost(bytes(bad))
            out["corrupt_raised"] = None
        except ValueError as e:
            out["corrupt_raised"] = f"{type(e).__name__}: {e}"
        out["corrupt_seconds"] = time.perf_counter() - t1
    out["reference_modules"] = [m for m in sys.modules if m.split(".")[0] in ("tpubz", "jax")]
    gathered = [None] * a.world
    dist.all_gather_object(gathered, out)
    if a.rank == 0:
        with open(f"{a.job}.world{a.world}.json", "w") as f:
            json.dump({str(r): res for r, res in enumerate(gathered)}, f)
    dist.destroy_process_group()
    return 0


def multihost(tpubz_torch, corpus, edges, rng, tmp):
    """The multi-process path on the card: compress_multihost as two gloo
    ranks on cuda:0 (subprocesses of this script) on a cut of the main
    path's data of 10 level-9 blocks: corpus blocks, a random block,
    bytes(range(256)) * 3500, the sidecar overflow block and the periodic
    tail. Rank 0's stream must equal tpubz_torch.compress's (device-only)
    and compress_cpu's, round-trip through decompress_multihost (two ranks)
    and bunzip2, and a corrupt copy must make both ranks raise; each rank
    must have launched all four batched kernels and no one-block kernel.
    Then one rank on the same data, for its MB/s beside the two ranks',
    compress's and compress_cpu's. Returns the two ranks' launches summed,
    by kernel."""
    from tpubz_torch.corpus import sidecar_overflow_block, with_tied_tail
    from tpubz_torch.stage_probe import DEVICE_ONLY, env

    data = with_tied_tail(corpus[: 6 * LEVEL * 100_000] + rng.bytes(LEVEL * 100_000)
                          + edges["all256"] + sidecar_overflow_block(), LEVEL)
    job = os.path.join(tmp, "multihost")
    with open(job + ".in", "wb") as f:
        f.write(data)
    ranks = _run_ranks(2, job, 300)
    with open(job + ".world2.bz2", "rb") as f:
        stream = f.read()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with env(**DEVICE_ONLY["full"]):
        want = tpubz_torch.compress(data, LEVEL, device="cuda")
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    blocks = tpubz_torch.stream.api.last_stream_stats["blocks"]
    t0 = time.perf_counter()
    host = tpubz_torch.compress_cpu(data, LEVEL)
    cpu_s = time.perf_counter() - t0
    if stream != want or stream != host:
        raise AssertionError("the two ranks' stream differs from compress's or compress_cpu's")
    if [r["stream_is_none"] for r in ranks] != [False, True]:
        raise AssertionError(f"only rank 0 returns the stream: {ranks}")
    if not all(r["decoded_equal"] for r in ranks):
        raise AssertionError("decompress_multihost on two ranks did not give the data back")
    if not all(r["corrupt_raised"] for r in ranks):
        raise AssertionError(f"a corrupt stream did not raise on every rank: {ranks}")
    for r, res in enumerate(ranks):
        got = res["launches"]
        if min(got[k] for k in ("bwt_batch", "mtf_batch", "rle2_batch", "compact")) < 1:
            raise AssertionError(f"rank {r} did not launch every batched kernel: {got}")
        if got["one_block"] or res["reference_modules"]:
            raise AssertionError(f"rank {r}: one-block launches or reference modules: {res}")
    steps = -(-blocks // 2)
    if any(res["launches"]["bwt_batch"] != steps for res in ranks):
        raise AssertionError(f"{blocks} blocks in {steps} steps, launches {ranks}")
    ran = ["decompress_multihost(2 ranks)"] + ["bunzip2"] * _bunzip2_ok(stream, data)
    one = _run_ranks(1, job, 300)[0]
    with open(job + ".world1.bz2", "rb") as f:
        if f.read() != stream:
            raise AssertionError("one rank's stream differs from two ranks'")
    mb = len(data) / 1e6
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ("bwt_batch", "mtf_batch", "rle2_batch", "compact")}
    _say("multihost", f"ranks=2 device=cuda:0 backend=gloo transport={ranks[0]['transport']} "
         f"blocks={blocks} steps={steps} MB={mb} stream==compress==compress_cpu "
         f"round_trips={'+'.join(ran)} corrupt_raised_on_every_rank=True "
         f"corrupt_seconds={max(r['corrupt_seconds'] for r in ranks)} "
         f"launches_by_rank={[r['launches'] for r in ranks]} bwt_rounds_by_rank="
         f"{[r['bwt_rounds'] for r in ranks]} rank1_payload_bytes_sent="
         f"{ranks[1]['payload_bytes_sent']} MBps_2_ranks={mb / ranks[0]['seconds']} "
         f"MBps_1_rank={mb / one['seconds']} MBps_2_ranks_cold={mb / ranks[0]['seconds_cold']} "
         f"MBps_1_rank_cold={mb / one['seconds_cold']} compress_device_only_MBps={mb / compress_s} "
         f"compress_cpu_MBps={mb / cpu_s} (host clock, barrier to barrier in the ranks, the "
         f"second call of each process; cold: its first; one card, both ranks on it)")
    return launches


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


ORACLE_TRACE_KB = 256  # the prefix the command line decodes with --trace-bits


class _CountLines(logging.Handler):
    """A logging handler that counts the records it is given."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = 0

    def emit(self, record):
        self.lines += 1


def oracle(tpubz_torch, short, want, edges, tmp):
    """The card's main-path kernels and streams against the scalar codec
    (tpubz_torch/hostref: numpy and Python lists, no code shared with the
    kernels or the native engine), tolerance 0. (a) The card's level-9
    stream of the short data (want, from [short]) equals
    hostref.stream.compress(short, 9). (b) On every level-9 block of the
    short data, as the scalar codec cuts it, and the ab...abc and
    bytes(range(256)) * 3500 edge blocks: transform_bwt and fetch_bwt give
    the key and last column of hostref.bwt.bwt_encode. (c) On the same
    blocks: transform and fetch give the RLE2 symbols, their length, the
    frequencies and the used map of hostref.mtf_rle2.mtf_rle2_encode of the
    scalar last column; the BWT, MTF and RLE2 kernels launched once a block
    each call and no plain version ran. (d) hostref.stream.decompress of
    the card's stream, its trace counted by a handler, gives the short data
    back. (e) python -m tpubz_torch -d --trace-bits on the card's stream of
    a prefix writes the prefix back with "read at bit" lines on its stderr,
    and cli.run([file], prog="tpcat") writes it to its stdout, each in a
    subprocess."""
    from tpubz_torch.block.encode import DeviceBlockEncoder
    from tpubz_torch.format.constants import block_budget
    from tpubz_torch.hostref import stream as scalar
    from tpubz_torch.hostref.bwt import bwt_encode
    from tpubz_torch.hostref.mtf_rle2 import mtf_rle2_encode
    from tpubz_torch.hostref.rle1 import rle1_encode, split_blocks
    from tpubz_torch.kernels import mtf, rle2, suffix_sort
    from tpubz_torch.stage_probe import DEVICE_ONLY, env

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    if scalar.compress(short, LEVEL) != want:
        raise AssertionError("the card's stream differs from the scalar encoder's")
    encode_s = time.perf_counter() - t0

    arr = np.frombuffer(short, np.uint8)
    out, seg_out, seg_in = rle1_encode(arr)
    blocks = [out[o0:o1] for o0, o1, _, _ in split_blocks(out, seg_out, seg_in,
                                                          block_budget(LEVEL))]
    blocks += [np.frombuffer(edges[k], np.uint8) for k in ("near_periodic", "all256")]
    enc = DeviceBlockEncoder(LEVEL)
    _zero_counts()
    torch.cuda.synchronize()
    scalar_block_s = 0.0
    with _PlainCalls([(suffix_sort, "bwt_forward_ref"), (mtf, "mtf_ranks_ref"),
                      (rle2, "rle2_encode_ref")]) as plain:
        for i, blk in enumerate(blocks):
            key, last = enc.fetch_bwt(enc.transform_bwt(blk))
            ckey, csyms, clen, cfreqs, cused = enc.fetch(enc.transform(blk))
            t0 = time.perf_counter()
            skey, slast = bwt_encode(blk)
            ssyms, sfreqs, sused = mtf_rle2_encode(slast)
            scalar_block_s += time.perf_counter() - t0
            if key != skey or ckey != skey or not np.array_equal(last, slast):
                raise AssertionError(f"block {i} ({blk.size} bytes): the card's BWT key or last "
                                     f"column differs from the scalar BWT's")
            if (clen != ssyms.size or not np.array_equal(csyms, ssyms)
                    or not np.array_equal(cfreqs, sfreqs) or not np.array_equal(cused, sused)):
                raise AssertionError(f"block {i} ({blk.size} bytes): the card's RLE2 symbols, "
                                     f"length, frequencies or used map differ from the scalar "
                                     f"MTF/RLE2's")
    nb = len(blocks)
    launches = {"bwt": suffix_sort.LAUNCHES, "mtf": mtf.LAUNCHES, "rle2": rle2.LAUNCHES}
    if launches != {"bwt": 2 * nb, "mtf": nb, "rle2": nb} or any(plain.calls.values()):
        raise AssertionError(f"oracle launches {launches} for {nb} blocks, plain calls "
                             f"{plain.calls}")

    counter = _CountLines()
    logger = logging.getLogger("tpubz_torch")
    level = logger.level
    logger.addHandler(counter)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False  # the trace goes to the counter, not the output
    try:
        t0 = time.perf_counter()
        back = scalar.decompress(want, trace=True)
        decode_s = time.perf_counter() - t0
    finally:
        logger.removeHandler(counter)
        logger.setLevel(level)
        logger.propagate = True
    if back != short:
        raise AssertionError("the scalar decoder did not give the short data back")

    prefix = short[: ORACLE_TRACE_KB << 10]
    with env(**DEVICE_ONLY["full"]):
        z = tpubz_torch.compress(prefix, LEVEL, device="cuda")
    src = os.path.join(tmp, "oracle.bz2")
    with open(src, "wb") as f:
        f.write(z)
    root = os.path.dirname(os.path.abspath(__file__))
    sub_env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (root, os.environ.get("PYTHONPATH")))))
    traced = subprocess.run([sys.executable, "-m", "tpubz_torch", "-d", "-k", "-f",
                             "--trace-bits", src], cwd=root, env=sub_env, capture_output=True,
                            timeout=600, check=True)
    cli_lines = traced.stderr.count(b"read at bit")
    with open(src[:-4], "rb") as f:
        if f.read() != prefix or not cli_lines:
            raise AssertionError("python -m tpubz_torch -d --trace-bits did not give the prefix "
                                 "back with its trace")
    cat = subprocess.run([sys.executable, "-c", "import sys; from tpubz_torch import cli; "
                          "sys.exit(cli.run(sys.argv[1:], prog='tpcat'))", src], cwd=root,
                         env=sub_env, capture_output=True, timeout=600, check=True)
    if cat.stdout != prefix:
        raise AssertionError("cli.run(prog='tpcat') did not write the prefix to stdout")
    _say("oracle", f"bytes={len(short)} stream==scalar_compress blocks={nb} "
         f"(level-9 blocks {nb - 2} + near_periodic + all256) bwt_key_last==scalar "
         f"rle2_syms_len_freqs_used==scalar launches={launches} plain_calls={plain.calls} "
         f"scalar_decompress==short trace_lines={counter.lines} "
         f"cli_trace_bits_prefix_bytes={len(prefix)} cli_trace_lines={cli_lines} "
         f"tpcat_stdout==prefix mismatches=0 tolerance=0 "
         f"scalar_encode_s={encode_s} scalar_blocks_s={scalar_block_s} "
         f"scalar_decode_traced_s={decode_s} phase_s={time.perf_counter() - t_phase} "
         f"(host clock)")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(main())

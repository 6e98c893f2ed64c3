"""Where an RLE2 call's time goes on the card, and the choices of
``csrc/rle2.cu`` held against the alternatives they replaced.

    python3 -m tpubz_torch.rle2_probe [--out FILE]

Needs a CUDA card and nvcc: without a card it exits with code 1. On the
MTF ranks of the first level-9 block of ``corpus.mixed_corpus(5, 2026)``,
and of its first five blocks as batch rows, it prints one JSON object,
also written to ``--out``:

- ``variants``: ``csrc/rle2.cu`` built as it is and with one choice undone,
  each into its own library (nvcc, sm_90a), timed on the same inputs by
  ``torch.profiler`` (device µs of the memset and of the kernel, the mean of
  20 calls), every output held equal to the plain version:
    - ``match_hist``: the histogram aggregated over the warp's equal
      literals by ``__match_any_sync`` (the three-kernel design's) in place
      of one shared atomic a literal;
    - ``tile_8192``: 512 threads a tile of 8192 ranks, about one tile an SM
      at level 9;
    - ``no_reload``: no second load, half-way through the staging, of the
      status words that the first found unpublished;
- ``timeline``: the kernel as it is, with ``%globaltimer`` read by each
  tile's thread 0 at its phases: percentiles over the tiles of the µs of
  the ticket, the load and segment walk, the two block scans, the staging,
  the look-back and the write, and of each tile's start and end from the
  first start;
- ``host_us``: host µs per call of ``rle2_encode_used`` and of its steps
  (``carve``, the library call with its two launches, the stream handle);
- ``fetch_ms``: host ms of ``DeviceBlockEncoder.fetch`` of a transform's
  result against the fetch that first converts the symbols to int16 (the
  form before uint16), in turns in one process, the device drained before
  each.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .block.encode import DeviceBlockEncoder, Pending, _small_vector, host_copies
from .corpus import mixed_corpus
from .kernels import _build, mtf, rle2
from .kernels.suffix_sort import bwt_forward_batch
from .stage_probe import _blocks

SOURCE = os.path.join(_build.CSRC_DIR, "rle2.cu")
_HIST = "      if (nz && r[k] + 1 < kBins) atomicAdd(&hist[r[k] + 1], 1);"
_MARKS = 8  # globaltimer words a tile
VARIANTS = {
    "as_is": [],
    "match_hist": [(_HIST, "      const int lit = nz ? r[k] + 1 : -1;\n"
                           "      const unsigned peers = __match_any_sync(kFull, lit);\n"
                           "      if (lit >= 0 && lit < kBins && __ffs(peers) - 1 == lane) "
                           "atomicAdd(&hist[lit], __popc(peers));")],
    "tile_8192": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "no_reload": [("    if (k == kPer / 2 && w0 == 0) w0 = first_word(status, tile);\n", "")],
    "timeline": [
        ("using Word = unsigned long long;",
         "using Word = unsigned long long;\n"
         "__device__ unsigned long long g_marks[8 * 256 * 8];\n"
         "__device__ __forceinline__ unsigned long long now() { unsigned long long v; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v)); return v; }"),
        ("  const int t = threadIdx.x, lane = t & 31;\n",
         "  const int t = threadIdx.x, lane = t & 31;\n  const unsigned long long m0 = now();\n"),
        ("  const int tile = s_tile;\n",
         "  const int tile = s_tile;\n  const unsigned long long m1 = now();\n"),
        ("  // the tile's nonzero before this thread's",
         "  const unsigned long long m2 = now();\n  // the tile's nonzero before this thread's"),
        ("  // published at once:",
         "  const unsigned long long m3 = now();\n  // published at once:"),
        ("  Seg before_tile = start_seg();\n",
         "  const unsigned long long m4 = now();\n  Seg before_tile = start_seg();\n"),
        ("  const Seg p = s_prefix;\n",
         "  const Seg p = s_prefix;\n  const unsigned long long m5 = now();\n"),
        ("  // the row's last tile:",
         "  if (t == 0) { unsigned long long* g = g_marks + "
         "(static_cast<size_t>(row) * nb + tile) * 8; g[0] = m0; g[1] = m1; g[2] = m2; "
         "g[3] = m3; g[4] = m4; g[5] = m5; g[6] = now(); }\n"
         "  // the row's last tile:"),
        ("extern \"C\" int tpubz_rle2(",
         "extern \"C\" int rle2_marks(void* out) { return static_cast<int>("
         "cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks))); }\nextern \"C\" int tpubz_rle2("),
    ],
}
PHASES = ("ticket", "load_and_walk", "two_scans", "staging", "look_back", "write")


def variant_sources() -> dict:
    """name -> the text of csrc/rle2.cu with the variant's edits. An edit
    whose text the source no longer holds raises: the probe follows the
    source."""
    with open(SOURCE) as f:
        src = f.read()
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in {SOURCE}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants(work: str) -> dict:
    """name -> ctypes library of each variant, all nvcc runs side by side."""
    cmds, paths = [], {}
    for name, text in variant_sources().items():
        d = os.path.join(work, name)
        os.makedirs(d)
        with open(os.path.join(d, "rle2.cu"), "w") as f:
            f.write(text)
        paths[name] = os.path.join(d, "lib.so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared", "-o",
                     paths[name], os.path.join(d, "rle2.cu")])
    _build._run_all(cmds)
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn in ("tpubz_rle2", "tpubz_rle2_batch"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _call(lib, ranks, lengths, eob, used, n0):
    """One call of a variant's library, the one-block form (used) or the
    batched (lengths, eob), on scratch room enough for any tile size."""
    B, N = ranks.shape
    dev = ranks.device
    room = B * (8 * 1024 + 16)
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if used is not None:
        (rl, scratch, freqs, syms), zero, zb = rle2.carve(
            dev, ((torch.int64, ()),),
            ((None, room), (torch.int64, (258,)), (torch.uint16, (N + 8,))))
        rc = lib.tpubz_rle2(ranks.data_ptr(), n0, N, 0, None, None, used.data_ptr(), scratch,
                            syms.data_ptr(), rl.data_ptr(), freqs.data_ptr(), zero, zb,
                            ctypes.byref(launched), stream)
    else:
        (rl, scratch, freqs, syms), zero, zb = rle2.carve(
            dev, ((torch.int32, (B,)),),
            ((None, room), (torch.int32, (B, 258)), (torch.uint16, (B, N + 8))))
        rc = lib.tpubz_rle2_batch(ranks.data_ptr(), lengths.data_ptr(), B, N, eob.data_ptr(),
                                  scratch, syms.data_ptr(), rl.data_ptr(), freqs.data_ptr(), zero,
                                  zb, ctypes.byref(launched), stream)
    if rc:
        raise RuntimeError(f"CUDA error {rc}")
    return syms, rl, freqs


def _device_us(fn, calls: int = 20) -> dict:
    """Device µs of fn by kind (memset, kernel), the mean of `calls` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = "memset" if "emset" in e.name else "kernel"
            out[kind] = out.get(kind, 0.0) + (e.time_range.end - e.time_range.start) / calls
    return out


def _timeline(lib, run, rows: int, nb: int) -> dict:
    run()
    torch.cuda.synchronize()
    run()
    torch.cuda.synchronize()
    buf = np.zeros(8 * 256 * _MARKS, np.uint64)
    if lib.rle2_marks(ctypes.c_void_p(buf.ctypes.data)):
        raise RuntimeError("reading the marks failed")
    m = buf.reshape(-1, _MARKS)[: rows * nb].astype(np.int64)
    q = lambda v: [float(x) for x in np.percentile(v, [0, 50, 90, 100])]  # noqa: E731
    out = {p: q(np.diff(m[:, :7], axis=1)[:, i] / 1e3) for i, p in enumerate(PHASES)}
    out.update(start=q((m[:, 0] - m[:, 0].min()) / 1e3), end=q((m[:, 6] - m[:, 0].min()) / 1e3))
    return out


def _host_us(fn, reps: int = 3000) -> float:
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps // 50):
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / reps * 1e6


def _fetch_int16(enc, out):
    """The fetch as it was with int16 symbols: a conversion launched first."""
    key, syms, rle2_len, freqs, used = out
    small = _small_vector(key, rle2_len, freqs, used)
    (h_small, h_syms), event = host_copies(enc.device, small, syms.to(torch.int16))

    def finish():
        s = h_small.numpy()
        rl = int(s[1])
        return int(s[0]), h_syms[:rl].numpy().view(np.uint16), rl, s[2:260].copy(), s[260:] != 0

    return Pending(event, finish).result()


def probe() -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    blocks = [b for b, _ in _blocks(mixed_corpus(5, 2026), 9)][:5]
    N = 900_096
    data = torch.zeros(len(blocks), N, dtype=torch.uint8)
    for b, blk in enumerate(blocks):
        data[b, : blk.size] = torch.tensor(blk)
    data = data.to(dev)
    ns = [int(b.size) for b in blocks]
    _, lasts = bwt_forward_batch(data, ns)
    ranks, used = mtf.mtf_ranks_batch(lasts, ns)
    lengths = torch.tensor(ns, dtype=torch.int32, device=dev)
    eob = used.sum(1, dtype=torch.int32) + 1
    one = (ranks[:1], None, None, used[0], ns[0])
    rows = (ranks, lengths, eob, None, 0)
    want_one = [t.long() for t in rle2.rle2_encode_ref(ranks[0], ns[0], eob[0])]
    want_rows = [t.long() for t in rle2.rle2_encode_batch_ref(ranks, ns, eob)]
    result: dict = {"variants": {}, "inputs": f"mixed_corpus(5, 2026) level-9 blocks {ns}"}
    with tempfile.TemporaryDirectory() as work:
        libs = build_variants(work)
        for name, lib in libs.items():
            got_one = [t.long() for t in _call(lib, *one)]
            got_rows = [t.long() for t in _call(lib, *rows)]
            if not all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got_one + got_rows,
                                                                     want_one + want_rows)):
                raise AssertionError(f"variant {name} disagrees with the plain version")
            if name == "timeline":
                result["timeline"] = {
                    "one_block": _timeline(lib, lambda: _call(lib, *one), 1, 220),
                    "batch_5": _timeline(lib, lambda: _call(lib, *rows), 5, 220)}
            else:
                result["variants"][name] = {
                    "one_block": _device_us(lambda: _call(lib, *one)),
                    "batch_5": _device_us(lambda: _call(lib, *rows))}
    r0, u0, n0 = ranks[0], used[0], ns[0]
    lib = _build.load()
    (rl, scratch, freqs, syms), zero, zb = rle2.carve(
        dev, ((torch.int64, ()),),
        ((None, rle2.scratch_bytes(1, N)), (torch.int64, (258,)), (torch.uint16, (N + 8,))))
    args = (r0.data_ptr(), n0, N, 0, None, None, u0.data_ptr(), scratch, syms.data_ptr(),
            rl.data_ptr(), freqs.data_ptr(), zero, zb)
    launched = ctypes.c_int(0)
    result["host_us"] = {
        "rle2_encode_used": _host_us(lambda: rle2.rle2_encode_used(r0, n0, u0)),
        "carve": _host_us(lambda: rle2.carve(
            dev, ((torch.int64, ()),),
            ((None, rle2.scratch_bytes(1, N)), (torch.int64, (258,)), (torch.uint16, (N + 8,))))),
        "library_call": _host_us(lambda: lib.tpubz_rle2(
            *args, ctypes.byref(launched), torch.cuda.current_stream(dev).cuda_stream)),
        "current_stream": _host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "used_sum_plus_1": _host_us(lambda: u0.sum() + 1),
    }
    enc = DeviceBlockEncoder(9, dev)
    times: dict = {"uint16": [], "int16": []}
    for blk in blocks[:4]:
        out = enc.transform(blk)
        a, b = enc.fetch(out), _fetch_int16(enc, out)
        if not (a[0] == b[0] and a[2] == b[2] and np.array_equal(a[1], b[1])):
            raise AssertionError("the two fetches disagree")
        for _ in range(25):
            for name, fn in (("uint16", enc.fetch), ("int16", lambda o: _fetch_int16(enc, o)),
                             ("int16", lambda o: _fetch_int16(enc, o)), ("uint16", enc.fetch)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(out)
                times[name].append((time.perf_counter() - t0) * 1e3)
    result["fetch_ms"] = {k: {"median": statistics.median(v), "q1": float(np.percentile(v, 25)),
                              "q3": float(np.percentile(v, 75)), "n": len(v)}
                          for k, v in times.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rle2_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, **probe()}
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

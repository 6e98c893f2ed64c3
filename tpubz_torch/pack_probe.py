"""The packing kernel and the compact form's kernel on the card, against
another checkout.

    python3 -m tpubz_torch.pack_probe [--mib 8] [--seed 2026] [--out FILE]
                                      [--parent DIR] [--reps 1]

Needs a CUDA card and nvcc: without a card it exits with code 1. Each turn
is a fresh process of one tree (this one, or with ``--parent`` the parent's
and this one in the order parent, this, this, parent, ``--reps`` times), on
inputs made from seeds in the same way in both trees:

- ``pack_bits``: 2^20 seeded fields of 0 to 24 bits (``chip_smoke.py``'s);
- ``pack_payload``: the corpus's first level-9 block
  (``corpus.mixed_corpus(1, seed)``) through ``DeviceBlockEncoder.transform``,
  its final tables from the device refinement, uint16 symbols and the
  device length (the encoder's call);
- ``stage_compact``: five level-9 rows (the corpus block, the near-periodic
  and ``all256`` edge blocks, seeded random bytes and the sidecar overflow
  block) through the batched transform, B = 5 (``chip_smoke.py``'s rows);

each call's ms (CUDA events, 20 calls back to back), its device µs by
kernel, their sum and its launches (``torch.profiler``, the mean of 20
calls), and every output equal to the plain version's; and
``encode_block_devrefine``'s host ms a block over the level-9 blocks of
``with_tied_tail(mixed_corpus(mib, seed) + edge_blocks(), 9)`` (the
transform done and waited for, as ``chip_smoke.py``'s [devrefine]). It
prints one JSON object, also written to ``--out``, with the card's name and
power limit. The parent is any checkout of the port, such as a ``git
archive`` of an earlier commit unpacked into a directory that
``.gitignore`` lists.

In this process it also builds ``csrc/bitpack.cu`` and ``csrc/compact.cu``
again, each into a library of its own (nvcc, sm_90a): ``as_is``, ``timeline``,
with ``%globaltimer`` read by each CTA's thread 0 at its phases (entry, the
ticket, its slice zeroed, its fields or symbols loaded, its count
published, its words built, its look-back done, its stores done),
``window_256``, the look-back reading 256
tiles at once (``csrc/look_back.cuh``'s kWindow = 8) in place of 32, and
``backoff_200``, 200 ns between polls of the status words in place of 20,
``build_gathered``, the packer's words built with a register gathering
a word's fields before one atomicOr a word (a branch a field) in place of
one atomicOr a field, and ``fence_and_relaxed_store``, the counts
published by a fence (``fence.acq_rel``) and a relaxed store in place of a
release store (``st.release``); on the three calls each gives the ms and device µs as
above (``variants``), and the timeline one call's percentiles of each
phase's µs over the CTAs that ran it, the spread of the CTAs' starts and
the kernel's span (``timeline``); and each call's host µs, 200 calls back
to back on the host's clock, with a ``cProfile`` of them (``host``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (phase, the mark it starts at, the mark it ends at)
PHASES = (("ticket", 0, 1), ("clear", 1, 2), ("load_symbols", 2, 9), ("load_tables", 9, 10),
          ("load", 10, 3), ("publish", 3, 4), ("build", 4, 7), ("look_back", 7, 5),
          ("store", 5, 6))
# the packer's marks inside its phases: (name, from, to)
INNER = (("scan", 3, 12),)
_HEAD = ('namespace {\n',
         'namespace {\n__device__ unsigned long long g_marks[1 << 17];\n'
         '__device__ __forceinline__ unsigned long long gtime() {\n'
         '  unsigned long long t;\n  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
         '  return t;\n}\n')
_MARKS = 'extern "C" int {}_marks(void* out) {{\n  return static_cast<int>(' \
         'cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks)));\n}}\n'
# thread 0 of each CTA writes marks ticket * 16 + (0 entry, 1 its ticket, 2
# its slice zeroed, 3 loaded, 4 published, 7 its words built in shared
# memory, 5 looked back, 6 stored)
TIMELINE = {
    "bitpack.cu": [
        _HEAD,
        ("  const int tid = threadIdx.x;\n  if (tid == 0) s_tile",
         "  const int tid = threadIdx.x;\n  const unsigned long long m0 = gtime();\n"
         "  if (tid == 0) s_tile"),
        ("  const int tile = s_tile;\n",
         "  const int tile = s_tile;\n  if (tid == 0) {\n    g_marks[tile * 16] = m0;\n"
         "    g_marks[tile * 16 + 1] = gtime();\n  }\n"),
        ("  tpubz::clear_stale(a.sc.status, stream_tiles, a.sc.dirty, tile, gridDim.x);\n",
         "  tpubz::clear_stale(a.sc.status, stream_tiles, a.sc.dirty, tile, gridDim.x);\n"
         "  if (tid == 0) g_marks[tile * 16 + 2] = "
         "g_marks[tile * 16 + 9] = g_marks[tile * 16 + 10] = gtime();\n"),
        ("        reinterpret_cast<uint4*>(s_codes)[k] = c[q];",
         "        if (tid == 0 && q == 0) {\n          unsigned got;\n"
         '          asm volatile("add.u32 %0, %1, %2;" : "=r"(got) : "r"(s[0]), "r"(t[0]));\n'
         "          g_marks[tile * 16 + 9] = gtime() + (got & 0);\n        }\n"
         "        reinterpret_cast<uint4*>(s_codes)[k] = c[q];"),
        ("    __syncthreads();\n#pragma unroll\n    for (int k = 0; k < kPer; ++k) {\n      v[k] = 0;",
         "    __syncthreads();\n    if (tid == 0) g_marks[tile * 16 + 10] = gtime();\n"
         "#pragma unroll\n    for (int k = 0; k < kPer; ++k) {\n      v[k] = 0;"),
        ("  int sum = 0;\n", "  if (tid == 0) g_marks[tile * 16 + 3] = gtime();\n  int sum = 0;\n"),
        ("  if (tid == kPublisher) {\n    tpubz::st_release(",
         "  if (tid == 0) g_marks[tile * 16 + 12] = gtime();\n"
         "  if (tid == kPublisher) {\n    tpubz::st_release("),
        ("  // the tile's words, counted from its own first bit",
         "  if (tid == 0) g_marks[tile * 16 + 4] = gtime();\n"
         "  // the tile's words, counted from its own first bit"),
        ("  // then warp 0 finds the bits before the tile",
         "  if (tid == 0) g_marks[tile * 16 + 7] = gtime();\n"
         "  // then warp 0 finds the bits before the tile"),
        ("    if (tid == 0) s_before = before;\n",
         "    if (tid == 0) {\n      s_before = before;\n      g_marks[tile * 16 + 5] = gtime();\n"
         "    }\n"),
        ("      a.words[gw] = x;\n    }\n  }\n}\n",
         "      a.words[gw] = x;\n    }\n  }\n  __syncthreads();\n"
         "  if (tid == 0) g_marks[tile * 16 + 6] = gtime();\n}\n"),
        ("// vals: device uint32[m]", _MARKS.format("pack") + "// vals: device uint32[m]"),
    ],
    "compact.cu": [
        _HEAD,
        ("  if (tid == 0) s_ticket = ",
         "  const unsigned long long m0 = gtime();\n  if (tid == 0) s_ticket = "),
        ("  const unsigned ticket = s_ticket;\n",
         "  const unsigned ticket = s_ticket;\n  if (tid == 0) {\n    g_marks[ticket * 16] = m0;\n"
         "    g_marks[ticket * 16 + 1] = g_marks[ticket * 16 + 2] = g_marks[ticket * 16 + 9] =\n"
         "        g_marks[ticket * 16 + 10] = gtime();\n  }\n"),
        ("  int flags = 0;\n", "  if (tid == 0) g_marks[ticket * 16 + 3] = gtime();\n  int flags = 0;\n"),
        ("  if (tid < 32) {\n", "  if (tid == 0) g_marks[ticket * 16 + 4] = "
         "g_marks[ticket * 16 + 7] = gtime();\n  if (tid < 32) {\n"),
        ("      s_before = static_cast<int>(before);\n",
         "      s_before = static_cast<int>(before);\n      g_marks[ticket * 16 + 5] = gtime();\n"),
        ("q[c] = make_uint4(0, 0, 0, 0);\n  }\n}\n",
         "q[c] = make_uint4(0, 0, 0, 0);\n  }\n  __syncthreads();\n"
         "  if (tid == 0) g_marks[ticket * 16 + 6] = gtime();\n}\n"),
        ("// syms: device uint16[B, out_len]",
         _MARKS.format("compact") + "// syms: device uint16[B, out_len]"),
    ],
}
# the look-back reading 256 tiles at once (8 words a lane) in place of 32
WINDOW_256 = ("constexpr int kWindow = 1;", "constexpr int kWindow = 8;")
# 200 ns between polls of the status words in place of 20
BACKOFF_200 = ("__nanosleep(20);", "__nanosleep(200);")
VARIANTS = {"as_is": [], "window_256": [WINDOW_256], "backoff_200": [BACKOFF_200]}
_BUILD_OLD = """    int pos = off;
    int cur = -1;  // the word the register holds
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (b[k] == 0) continue;  // no shift by 32
      const int wi = pos >> 5;
      const int end = (pos & 31) + b[k];
      if (wi != cur) {
        if (acc) atomicOr(s_words + cur, acc);
        cur = wi;
        acc = 0;
      }
      if (end <= 32) {
        acc |= v[k] << (32 - end);
      } else {  // the field's low end - 32 bits open the next word
        const uint32_t hi = acc | (v[k] >> (end - 32));
        if (hi) atomicOr(s_words + wi, hi);
        cur = wi + 1;
        acc = v[k] << (64 - end);
      }
      pos += b[k];
    }
    if (acc) atomicOr(s_words + cur, acc);
"""
_BUILD_DIRECT = """    int pos = off;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int wi = pos >> 5;
      const int end = (pos & 31) + b[k];
      if (b[k]) {  // no shift by 32
        atomicOr(s_words + wi, end <= 32 ? v[k] << (32 - end) : v[k] >> (end - 32));
        if (end > 32) atomicOr(s_words + wi + 1, v[k] << (64 - end));
      }
      pos += b[k];
    }
"""
# csrc/bitpack.cu with a register gathering the fields of one word before
# one atomicOr a word (a branch a field), in place of one atomicOr a field
BUILD_VARIANTS = {"build_gathered": [(_BUILD_DIRECT, _BUILD_OLD)]}
# csrc/bitpack.cu publishing its counts with a fence (fence.acq_rel) and a
# relaxed store in place of a release store
_FENCE = ('asm volatile("fence.acq_rel.gpu;" ::: "memory");\n'
          '  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");')
VARIANTS["fence_and_relaxed_store"] = [
    ('asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");', _FENCE)]

# the three calls on seeded inputs (``calls``: name -> (run, plain)) and the
# helpers that time them; run by each turn and, for the variants, here
_INPUTS = r"""
import json, statistics, sys, time
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from tpubz_torch.block.encode import DeviceBlockEncoder, payload_tables
from tpubz_torch.corpus import edge_blocks, mixed_corpus, sidecar_overflow_block
from tpubz_torch.dist.sharded import make_sharded_transform
from tpubz_torch.format.constants import block_budget
from tpubz_torch.format.crc import block_crc
from tpubz_torch.hostref.huffman import canonical_codes
from tpubz_torch.hostref.rle1 import rle1_blocks
from tpubz_torch.kernels import bitpack, compact, huffman_dev as H

seed = SEED
dev = torch.device("cuda")

def ms(fn, reps=20):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); b.synchronize()
    return a.elapsed_time(b) / reps

def device(fn, calls=20):
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in evs:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (e.time_range.end - e.time_range.start) / calls
    return {"sum_us": sum(by_name.values()), "launches": len(evs) / calls, "kernels_us": by_name}

def held(got, want):
    torch.cuda.synchronize()
    if not all(torch.equal(g.long(), w.long()) for g, w in zip(got, want)):
        raise AssertionError("a kernel disagrees with its plain version")

calls = {}
rng = np.random.default_rng(seed + 9)
m = 1 << 20
fbits = rng.integers(0, 25, m).astype(np.int32)
fvals = (rng.integers(0, 1 << 24, m) & ((1 << fbits) - 1)).astype(np.uint32)
vals = torch.from_numpy(fvals.view(np.int32)).to(dev)
fb = torch.from_numpy(fbits).to(dev)
cap = (int(fbits.sum()) + 31) // 32 + 1
calls["pack_bits"] = (lambda: bitpack.pack_bits_device(vals, fb, cap),
                      lambda: bitpack.pack_bits_device_ref(vals, fb, cap))

enc = DeviceBlockEncoder(9)
blk0 = np.frombuffer(mixed_corpus(1, seed)[:900_000], np.uint8)
out = enc.transform(blk0)
_, _, rl, freqs, used = enc.fetch(out)
alpha = int(used.sum()) + 2
sel, lens, rfreq, tc, _ = enc.devrefine_tables(out[1], out[2], rl, freqs, alpha)
codes = np.stack([canonical_codes(lens[t, :alpha]) for t in range(tc)])
tables = payload_tables(sel, codes, lens, tc, alpha, out[1].shape[0], dev)
syms, rl_d = out[1], out[2]
calls["pack_payload"] = (lambda: H.pack_payload(syms, rl_d, *tables),
                         lambda: H.pack_payload_ref(syms, rl_d, *tables))

edges = edge_blocks()
rows = [mixed_corpus(1, seed)[:900_000], edges["near_periodic"], edges["all256"],
        np.random.default_rng(seed).bytes(899_001), sidecar_overflow_block()]
data = torch.zeros(len(rows), 900_096, dtype=torch.uint8)
for b, row in enumerate(rows):
    data[b, : len(row)] = torch.frombuffer(bytearray(row), dtype=torch.uint8)
bsyms, blens = make_sharded_transform(dev, 900_096)(data.to(dev), [len(r) for r in rows])[1:3]
calls["stage_compact"] = (lambda: compact.stage_compact(bsyms, blens),
                          lambda: compact.stage_compact_ref(bsyms, blens))

"""

_TURN = _INPUTS + r"""
res = {}
for name, (run, plain) in calls.items():
    held(run(), plain())
    res[name] = {"ms": ms(run), "device": device(run)}

with open(DATA, "rb") as f:
    arr = np.frombuffer(f.read(), np.uint8)
rle1, cuts = rle1_blocks(arr, block_budget(9))
host = []
for o0, o1, i0, i1 in cuts:
    t = enc.transform(rle1[o0:o1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc.encode_block_devrefine(t, block_crc(arr[i0:i1]))
    host.append((time.perf_counter() - t0) * 1e3)
res["devrefine_host_ms_per_block_median"] = statistics.median(host)
res["devrefine_blocks"] = len(host)
print("TURN " + json.dumps(res))
"""


def _edited(name: str, edits) -> str:
    """csrc/<name> with each edit applied; an edit whose text the source
    does not hold once raises: the probe follows the source."""
    from .kernels import _build

    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the edit {old!r} is not once in {name}")
        text = text.replace(old, new)
    return text


def build(work: str) -> dict:
    """The variants' libraries by name (bitpack.cu and compact.cu, edited,
    linked into one library each; nvcc runs side by side)."""
    import ctypes

    from .kernels import _build

    sources = {name: {"look_back.cuh": edits} for name, edits in VARIANTS.items()}
    sources["timeline"] = dict(TIMELINE)
    sources.update({name: {"bitpack.cu": edits} for name, edits in BUILD_VARIANTS.items()})
    cmds, paths = [], {}
    for name, edits in sources.items():
        d = os.path.join(work, name)
        os.makedirs(d)
        for file in ("bitpack.cu", "compact.cu", "look_back.cuh"):
            with open(os.path.join(d, file), "w") as f:
                f.write(_edited(file, edits.get(file, [])))
        paths[name] = os.path.join(d, "lib.so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared", "-o",
                     paths[name], os.path.join(d, "bitpack.cu"), os.path.join(d, "compact.cu")])
    _build._run_all(cmds)
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn in ("tpubz_pack_bits_device", "tpubz_pack_payload", "tpubz_stage_compact"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _timeline(marks_of, run) -> dict:
    """One call of ``run`` on the timeline library after a warm-up: per
    phase the percentiles (0, 50, 90, 100) of its µs over the CTAs that ran
    it, the spread of the CTAs' starts and the kernel's span (µs)."""
    import ctypes

    import numpy as np

    marks_of.argtypes = [ctypes.c_void_p]
    marks_of.restype = ctypes.c_int
    for _ in range(2):
        run()
        torch.cuda.synchronize()
    marks = np.zeros(1 << 17, np.uint64)
    if marks_of(ctypes.c_void_p(marks.ctypes.data)):
        raise RuntimeError("reading the marks failed")
    m = marks.astype(np.int64).reshape(-1, 16)
    live = m[(m[:, 0] > 0) & (m[:, 0] >= m[:, 0].max() - 1_000_000)]  # this call's CTAs
    q = lambda v: [float(x) for x in np.percentile(v, [0, 50, 90, 100])] if len(v) else None  # noqa: E731
    out = {"ctas": int(len(live)),
           "start_spread_us": float((live[:, 0].max() - live[:, 0].min()) / 1e3)}
    end = live[:, 0].max()
    reached = np.ones(len(live), bool)
    for phase, a, b in PHASES:
        reached &= live[:, b] >= live[:, a]  # marks of this call only: not before its start
        ran = live[reached]
        out[f"{phase}_us"] = q((ran[:, b] - ran[:, a]) / 1e3)
        out[f"{phase}_ctas"] = int(len(ran))
        if len(ran):
            end = max(end, ran[:, b].max())
    out["span_us"] = float((end - live[:, 0].min()) / 1e3)
    for phase, a, b in INNER:
        ran = live[(live[:, a] > 0) & (live[:, b] >= live[:, a]) & (live[:, a] >= live[:, 0])]
        out[f"{phase}_us"] = q((ran[:, b] - ran[:, a]) / 1e3)
    return out


def variants(work: str, seed: int) -> tuple[dict, dict]:
    """Each variant's ms and device µs on the three calls (its library in
    place of the port's for them), every output equal to the plain
    version's; and the timeline variant's phases."""
    from .kernels import _build

    libs = build(work)
    ns = {"SEED": seed}
    exec(_INPUTS, ns)  # noqa: S102 (the probe's own script)
    result, timeline = {}, {}
    kept = _build.load()
    try:
        for name, lib in libs.items():
            _build._lib = lib
            result[name] = {}
            for call, (run, plain) in ns["calls"].items():
                ns["held"](run(), plain())
                result[name][call] = {"ms": ns["ms"](run), "device": ns["device"](run)}
                if name == "timeline":
                    marks_of = lib.compact_marks if call == "stage_compact" else lib.pack_marks
                    timeline[call] = _timeline(marks_of, run)
    finally:
        _build._lib = kept
    return result, timeline


def host(seed: int, calls: int = 200, top: int = 8) -> dict:
    """Each call's host µs: ``calls`` calls back to back on the host's clock
    (the card runs behind), then the same under ``cProfile`` with the top
    functions by their own time a call (which slows every Python call it
    sees: read the shares)."""
    import cProfile
    import pstats
    import time

    ns = {"SEED": seed}
    exec(_INPUTS, ns)  # noqa: S102 (the probe's own script)
    out = {}
    for name, (run, _) in ns["calls"].items():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(calls):
            run()
        prof.disable()
        torch.cuda.synchronize()
        stats = pstats.Stats(prof).stats
        rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
        out[name] = {"host_us_per_call": us, "profiled_own_us_per_call": {
            f"{os.path.basename(f)}:{line}:{fn}": st[2] / calls * 1e6
            for (f, line, fn), st in rows}}
    return out


def _turn(tree: str, data_path: str, seed: int) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    script = f"SEED = {seed}\nDATA = {data_path!r}\n" + _TURN
    proc = subprocess.run([sys.executable, "-c", script], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"the turn in {tree} failed:\n{proc.stderr[-4000:]}")
    line = next(s for s in proc.stdout.splitlines() if s.startswith("TURN "))
    return json.loads(line[5:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=8)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--out")
    ap.add_argument("--parent")
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pack_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from .corpus import edge_blocks, mixed_corpus, with_tied_tail

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    data = with_tied_tail(mixed_corpus(args.mib, args.seed) + b"".join(edge_blocks().values()), 9)
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "data": f"with_tied_tail(mixed_corpus({args.mib}, seed={args.seed}) + "
                      f"edge_blocks(), 9)", "bytes": len(data)}
    trees = [("this", ROOT)]
    if args.parent:
        parent = os.path.abspath(args.parent)
        result["parent"] = parent
        trees = [("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)]
    with tempfile.TemporaryDirectory() as work:
        result["variants"], result["timeline"] = variants(work, args.seed)
        result["host"] = host(args.seed)
        path = os.path.join(work, "data.bin")
        with open(path, "wb") as f:
            f.write(data)
        result["turns"] = [{"tree": name, **_turn(tree, path, args.seed)}
                           for _ in range(args.reps) for name, tree in trees]
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The refinement pass and the inverse BWT on the card, against another
checkout and at other splitter densities.

    python3 -m tpubz_torch.ibwt_probe [--mib 16] [--seed 2026] [--out FILE]
                                      [--parent DIR [--reps 1]]

Needs a CUDA card and nvcc: without a card it exits with code 1. Its data is
``chip_smoke.py``'s main path: ``corpus.mixed_corpus(mib, seed)``, the edge
blocks and a periodic tail (``corpus.with_tied_tail``), cut into level-9
blocks as ``compress`` cuts them; "block 0" is the corpus's first (nine
doubling rounds in the BWT). It prints one JSON object, also written to
``--out``:

- ``l2_chase``: one thread following a random cycle through 900,096 4-byte
  words (3.6 MB, held in the L2 after a first lap), ns a step from CUDA
  events (the difference of 20,000 and 10,000 steps): the latency of one
  dependent load of a walk;
- ``refine_shapes``: ``csrc/huffman_dev.cu`` built with other CTA shapes
  of ``refine_symbols`` (``kRefineWarps``, ``kRefineCtas``: warps a CTA and
  the most CTAs, so the most global atomics of the CTAs' sums), each into
  its own library; on block 0 with C bzip2's initial tables for six tables
  the pass's ms (CUDA events, 20 calls back to back) and device µs and
  launches (``torch.profiler``, one call), its outputs equal to the plain
  version's;
- ``refine_shapes`` ``runs_in_registers``: ``refine_symbols`` with RUNA and
  RUNB, the hot bins, counted in registers and added once a group in place
  of one shared atomic a symbol;
- ``refine_shapes`` ``lens_16bit``: ``refine_symbols`` with each length in
  16 bits (one 16-byte shared load a symbol) in place of a byte (8 bytes);
- ``refine_shapes`` ``timeline``: ``refine_symbols`` as it is with
  ``%globaltimer`` read by each CTA at its phases (the lengths into shared
  memory, the tiles, the sums added and fenced) and the last CTA's fold, on
  block 0: percentiles of each phase's µs over the CTAs, the spread of
  their starts and the kernel's span;
- ``variants`` ``timeline``: ``csrc/ibwt.cu`` as it is with ``%globaltimer``
  read at the phases of its orbit kernels, on block 0: the CTAs' µs and each
  kernel's span, the gaps between the kernels, ``rank_top``'s phases (the
  load, the walks in shared memory, the doubling, the offsets) and the
  fill;
- ``variants``: ``csrc/ibwt.cu`` built as it is and at other splitter
  densities (``kLog1``, ``kLog2``, ``kLog3``: log2 of the windows of rows,
  of level-1 nodes and of the top's levels), each into its own library
  (nvcc, sm_90a); on block 0 the call's ms (CUDA events, 20 calls back to
  back), its device µs by kernel, their sum and their union and its
  launches (``torch.profiler``, one call), its span on the card five times (CUDA
  events around one call behind a sleeping stream, no profiler),
  its record (the walks, as the card counted them) and the latency bound
  (the longest level-1 and level-2 walks times ``l2_chase``), every output
  equal to the block; and on every block the median ms a call;
- ``turns`` (with ``--parent``): from a fresh process of the parent's tree
  and of this one in the order parent, this, this, parent (``--reps``
  times): ``refine_pass`` on block 0 as each tree's encoder calls it (the
  parent: over ``chunk_hist``'s histogram; here: over the symbols, the
  block's ``RefinePasses.launch``), C bzip2's initial tables for six tables, its
  ms (CUDA events, 20 calls), device µs and launches (``torch.profiler``,
  the mean of 20 calls) and span on the card (three calls, no profiler);
  ``encode_block_devrefine``'s host ms a block over the blocks
  (the transform done and waited for), and where the tree has it
  (the encoder's ``devrefine_host_us``) a pass's host µs by part (upload,
  launch, fetch, tree builds); ``bwt_inverse_device`` on block 0 (ms,
  device µs and span as above) and its ms a block over the blocks (CUDA events
  around each call, host launch included, as ``chip_smoke.py``'s [ibwt]).
  The parent is any checkout of the port, such as a ``git archive`` of an
  earlier commit unpacked into a directory that ``.gitignore`` lists.
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

import numpy as np
import torch

from .corpus import edge_blocks, mixed_corpus, with_tied_tail
from .kernels import _build, ibwt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_build.CSRC_DIR, "ibwt.cu")
# log2 of the windows of rows, of level-1 nodes and of level-2 nodes
DENSITIES = {"as_is": ibwt.LOG_D, "d1_16_d2_4": (4, 2, 3), "d1_4_d2_16": (2, 4, 3),
             "d1_16_d2_8": (4, 3, 3)}

REFINE_SOURCE = os.path.join(_build.CSRC_DIR, "huffman_dev.cu")
# refine_symbols' CTA shape: (warps a CTA, the most CTAs)
REFINE_SHAPES = {"as_is": (16, 132), "ctas_48": (16, 48), "warps_8": (8, 132)}
# refine_symbols with each length in 16 bits (16 bytes a symbol: one
# 16-byte shared load) in place of a byte (an 8-byte load)
LENS_16BIT = [
    ("  __shared__ uint2 s_len[kAlpha + 1];", "  __shared__ uint4 s_len[kAlpha + 1];"),
    ("    uint32_t w[2] = {0, 0};", "    uint32_t w[3] = {0, 0, 0};"),
    ("      w[t >> 2] |= (l & 0xffu) << (8 * (t & 3));", "      w[t >> 1] |= (l & 0xffffu) << (16 * (t & 1));"),
    ("    s_len[s] = make_uint2(w[0], w[1]);", "    s_len[s] = make_uint4(w[0], w[1], w[2], 0);"),
    ("      const uint2 l = s_len[mine[q]];\n      c[0] += l.x & 0xff;\n      c[1] += (l.x >> 8) & 0xff;\n"
     "      c[2] += (l.x >> 16) & 0xff;\n      c[3] += l.x >> 24;\n      c[4] += l.y & 0xff;\n"
     "      c[5] += (l.y >> 8) & 0xff;\n",
     "      const uint4 l = s_len[mine[q]];\n      c[0] += l.x & 0xffff;\n      c[1] += l.x >> 16;\n"
     "      c[2] += l.y & 0xffff;\n      c[3] += l.y >> 16;\n      c[4] += l.z & 0xffff;\n"
     "      c[5] += l.z >> 16;\n"),
]
# refine_symbols with RUNA and RUNB, the hot bins, counted in registers and
# added once a group, in place of one shared atomic a symbol
RUNS_IN_REGISTERS = [(
    "    int* f = s_rfreq + best * kAlpha;\n#pragma unroll 5\n"
    "    for (int q = 0; q < kLaneSyms; ++q) {\n      const int s = mine[q];\n"
    "      if (s < kAlpha) atomicAdd(f + s, 1);\n    }\n",
    "    int* f = s_rfreq + best * kAlpha;\n    int run_a = 0, run_b = 0;\n#pragma unroll 5\n"
    "    for (int q = 0; q < kLaneSyms; ++q) {\n      const int s = mine[q];\n"
    "      if (s < 2) { run_a += s == 0; run_b += s; } else if (s < kAlpha) atomicAdd(f + s, 1);\n"
    "    }\n    run_a += __shfl_xor_sync(kFull, run_a, 1);\n"
    "    run_b += __shfl_xor_sync(kFull, run_b, 1);\n"
    "    if ((lane & 1) == 0) { if (run_a) atomicAdd(f, run_a); if (run_b) atomicAdd(f + 1, run_b); }\n")]
# the timeline variant: csrc/ibwt.cu as it is, with %globaltimer read by
# thread 0 of each CTA at its phases into g_marks (ns): walk_rows' and
# walk_list's CTAs at their start and end (words 0.., 9000..), rank_top's
# phases (9200..: start, loaded, walked, ranked, done), write_orbit's CTAs at
# their start and once their bytes are stored (10000..), and its last CTA's
# fill (12000: start, end)
_NOW = ("__device__ unsigned long long g_marks[16384];\n"
        "__device__ __forceinline__ unsigned long long now() { unsigned long long v; "
        "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v)); return v; }\n")
_T0 = "  const unsigned long long m0 = now();\n"
TIMELINE = [
    ("constexpr int kOrbitKernels = 4;\n", "constexpr int kOrbitKernels = 4;\n" + _NOW),
    ("uint8_t* __restrict__ bytes, uint32_t* __restrict__ resume, int* rec) {\n",
     "uint8_t* __restrict__ bytes, uint32_t* __restrict__ resume, int* rec) {\n" + _T0),
    ("  cta_count(len > 0, len, rec, kRecSplitters, kRecLongest, s_count);\n",
     "  cta_count(len > 0, len, rec, kRecSplitters, kRecLongest, s_count);\n"
     "  if (threadIdx.x == 0) { g_marks[2 * blockIdx.x] = m0; "
     "g_marks[2 * blockIdx.x + 1] = now(); }\n"),
    ("              uint2* __restrict__ node2, int* rec) {\n",
     "              uint2* __restrict__ node2, int* rec) {\n" + _T0),
    ("  cta_count(nodes > 0, nodes, rec, kRecListSplitters, kRecListLongest, s_count);\n",
     "  cta_count(nodes > 0, nodes, rec, kRecListSplitters, kRecListLongest, s_count);\n"
     "  if (threadIdx.x == 0) { g_marks[9000 + 2 * blockIdx.x] = m0; "
     "g_marks[9001 + 2 * blockIdx.x] = now(); }\n"),
    ("  extern __shared__ uint4 sh4[];\n",
     "  extern __shared__ uint4 sh4[];\n  if (threadIdx.x == 0) g_marks[9200] = now();\n"),
    ("  unsigned walks = walk_shared(lvl2, lv.m2, j0, lvl3, false);\n",
     "  if (threadIdx.x == 0) g_marks[9201] = now();\n"
     "  unsigned walks = walk_shared(lvl2, lv.m2, j0, lvl3, false);\n"),
    ("  walks += walk_shared(lvl3, lv.m3, i0, lvl4, true);\n  __syncthreads();\n",
     "  walks += walk_shared(lvl3, lv.m3, i0, lvl4, true);\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) g_marks[9202] = now();\n"),
    ("  const uint32_t orbit = lvl4[h0].y;",
     "  if (threadIdx.x == 0) g_marks[9203] = now();\n  const uint32_t orbit = lvl4[h0].y;"),
    ("  if (threadIdx.x == 0) rec[kRecOrbit] = static_cast<int>(orbit);\n",
     "  if (threadIdx.x == 0) rec[kRecOrbit] = static_cast<int>(orbit);\n"
     "  if (threadIdx.x == 0) g_marks[9204] = now();\n"),
    ("  __shared__ uint8_t s_period[kFillShared];\n",
     "  __shared__ uint8_t s_period[kFillShared];\n" + _T0),
    ("  cta_count(mine, 0, rec, kRecSegments, -1, s_count);\n",
     "  if (threadIdx.x == 0) g_marks[10000 + 2 * blockIdx.x] = m0;\n"
     "  cta_count(mine, 0, rec, kRecSegments, -1, s_count);\n"
     "  if (threadIdx.x == 0) g_marks[10001 + 2 * blockIdx.x] = now();\n"),
    ("  const int orbit = __ldcg(rec + kRecOrbit);\n",
     "  if (threadIdx.x == 0) g_marks[12000] = now();\n"
     "  const int orbit = __ldcg(rec + kRecOrbit);\n"),
    ("  if (threadIdx.x < kRecWords) pinned[threadIdx.x] = __ldcg(rec + threadIdx.x);\n",
     "  if (threadIdx.x == 0) g_marks[12001] = now();\n"
     "  if (threadIdx.x < kRecWords) pinned[threadIdx.x] = __ldcg(rec + threadIdx.x);\n"),
    ('extern "C" int tpubz_ibwt_sizes(',
     'extern "C" int ibwt_marks(void* out) { return static_cast<int>('
     'cudaMemcpyFromSymbol(out, tpubz::radix::g_marks, sizeof(tpubz::radix::g_marks))); }\n'
     'extern "C" int tpubz_ibwt_sizes('),
]


# refine_symbols' timeline: each CTA's thread 0 at its start, once the
# lengths are in shared memory (its first tile's loads in flight), once its
# tiles are counted, once its sums
# are added and fenced (words 6 a CTA from 0), and the last CTA's fold's
# end (word 5 of its six)
_REFINE_NOW = _NOW.replace("g_marks[16384]", "g_marks[4096]")
REFINE_TIMELINE = [
    ("constexpr unsigned kFull = 0xffffffffu;\n",
     "constexpr unsigned kFull = 0xffffffffu;\n" + _REFINE_NOW),
    ("  __shared__ bool s_last;\n  long long len = row_length(rle2_len, len_bytes, 0);\n",
     "  __shared__ bool s_last;\n  const unsigned long long m0 = now();\n"
     "  long long len = row_length(rle2_len, len_bytes, 0);\n"),
    ("  for (int k = threadIdx.x; k < kSums; k += blockDim.x) s_rfreq[k] = 0;\n  __syncthreads();\n",
     "  for (int k = threadIdx.x; k < kSums; k += blockDim.x) s_rfreq[k] = 0;\n  __syncthreads();\n"
     "  const unsigned long long m1 = now();\n"),
    ("    __syncwarp();  // the tile's symbols are read before the next tile's land\n  }\n"
     "  __syncthreads();\n",
     "    __syncwarp();  // the tile's symbols are read before the next tile's land\n  }\n"
     "  __syncthreads();\n  const unsigned long long m2 = now();\n"),
    ("  __threadfence();\n  __syncthreads();\n  if (threadIdx.x == 0) {\n    s_last",
     "  __threadfence();\n  __syncthreads();\n  if (threadIdx.x == 0) { g_marks[6 * blockIdx.x] = m0; "
     "g_marks[6 * blockIdx.x + 1] = m1; g_marks[6 * blockIdx.x + 2] = m2; "
     "g_marks[6 * blockIdx.x + 3] = now(); }\n  if (threadIdx.x == 0) {\n    s_last"),
    ("  if (threadIdx.x == 0) scratch[kSums] = 0;\n",
     "  if (threadIdx.x == 0) scratch[kSums] = 0;\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) g_marks[6 * blockIdx.x + 4] = now();\n"),
    ('extern "C" int tpubz_refine_scratch_words()',
     'extern "C" int refine_marks(void* out) { return static_cast<int>('
     'cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks))); }\n'
     'extern "C" int tpubz_refine_scratch_words()'),
]


def _edited(path: str, edits) -> str:
    """The text of path with each edit applied; an edit whose text the source
    does not hold once raises: the probe follows the source."""
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the timeline edit {old!r} is not once in {path}")
        text = text.replace(old, new)
    return text


def refine_timeline_source() -> str:
    """csrc/huffman_dev.cu with REFINE_TIMELINE's edits."""
    return _edited(REFINE_SOURCE, REFINE_TIMELINE)


def density_edits(logs) -> list:
    """csrc/ibwt.cu's splitter windows set to log2 ``logs`` (rows, level-1
    nodes, the top's levels)."""
    return [(f"constexpr int kLog{k} = {v};", f"constexpr int kLog{k} = {logs[k - 1]};")
            for k, v in zip((1, 2, 3), ibwt.LOG_D)]


def shape_edits(shape) -> list:
    """refine_symbols' CTA shape set to (warps a CTA, the most CTAs)."""
    warps, ctas = shape
    return [("constexpr int kRefineWarps = 16;", f"constexpr int kRefineWarps = {warps};"),
            ("constexpr int kRefineCtas = 132;", f"constexpr int kRefineCtas = {ctas};")]


def timeline_source() -> str:
    """csrc/ibwt.cu with TIMELINE's edits."""
    return _edited(SOURCE, TIMELINE)


_CHASE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void chase(const uint32_t* next, int steps, uint32_t* out) {
  uint32_t p = 0;
  for (int i = 0; i < steps; ++i) p = __ldg(next + p);
  *out = p;
}
extern "C" int l2_chase(const void* next, int steps, void* out, void* stream) {
  chase<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const uint32_t*>(next), steps,
                                                        static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def level9_data(mib: int, seed: int) -> bytes:
    """chip_smoke.py's main-path data."""
    return with_tied_tail(mixed_corpus(mib, seed) + b"".join(edge_blocks().values()), 9)


def build(work: str) -> tuple[dict, dict, ctypes.CDLL]:
    """The density variants' libraries by name, the refinement's CTA shapes'
    and the chase's, all nvcc runs side by side."""
    cmds, paths, refine_paths = [], {}, {}
    sources = {name: _edited(SOURCE, density_edits(logs)) for name, logs in DENSITIES.items()}
    sources["timeline"] = timeline_source()
    refine = {name: _edited(REFINE_SOURCE, shape_edits(shape))
              for name, shape in REFINE_SHAPES.items()}
    refine.update(timeline=refine_timeline_source(),
                  runs_in_registers=_edited(REFINE_SOURCE, RUNS_IN_REGISTERS),
                  lens_16bit=_edited(REFINE_SOURCE, LENS_16BIT))
    for out, texts, stem in ((paths, sources, "ibwt"), (refine_paths, refine, "refine")):
        for name, text in texts.items():
            src = os.path.join(work, f"{stem}_{name}.cu")
            with open(src, "w") as f:
                f.write(text)
            out[name] = os.path.join(work, f"{stem}_{name}.so")
            cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared",
                         "-o", out[name], src])
    chase_src = os.path.join(work, "chase.cu")
    with open(chase_src, "w") as f:
        f.write(_CHASE)
    chase_path = os.path.join(work, "chase.so")
    cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", chase_path, chase_src])
    _build._run_all(cmds)
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn in ("tpubz_ibwt_sizes", "tpubz_bwt_inverse"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    refine_libs = {}
    for name, path in refine_paths.items():
        lib = ctypes.CDLL(path)
        for fn in ("tpubz_refine_pass", "tpubz_refine_scratch_words"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        refine_libs[name] = lib
    chase = ctypes.CDLL(chase_path)
    chase.l2_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    chase.l2_chase.restype = ctypes.c_int
    return libs, refine_libs, chase


def refine_shapes(libs: dict, syms: torch.Tensor, rl_d: torch.Tensor, lens: torch.Tensor) -> dict:
    """Each CTA shape's refinement pass on block 0: ms (CUDA events, 20 calls
    back to back), device µs and launches (torch.profiler, one call), its
    outputs equal to the plain version's."""
    from .kernels import huffman_dev as H
    from .stage_probe import kernel_device_us

    want = H.refine_pass_ref(syms, rl_d, lens, 6)
    OUT = syms.shape[0]
    result = {}
    for name, lib in libs.items():
        scratch = torch.zeros(lib.tpubz_refine_scratch_words(), dtype=torch.int32, device="cuda")
        sel = torch.empty(H.nsel_cap(OUT), dtype=torch.int8, device="cuda")
        rfreq = torch.empty(6, 258, dtype=torch.int32, device="cuda")

        def run(lib=lib, scratch=scratch, sel=sel, rfreq=rfreq):
            if lib.tpubz_refine_pass(syms.data_ptr(), syms.element_size(), rl_d.data_ptr(),
                                     rl_d.element_size(), OUT, lens.data_ptr(), 6, sel.data_ptr(),
                                     rfreq.data_ptr(), scratch.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream):
                raise RuntimeError(f"refine variant {name} did not launch")

        run()
        torch.cuda.synchronize()
        if not (torch.equal(sel, want[0]) and torch.equal(rfreq, want[1])):
            raise AssertionError(f"refine variant {name} differs from the plain version")
        if name == "timeline":
            lib.refine_marks.argtypes = [ctypes.c_void_p]
            lib.refine_marks.restype = ctypes.c_int
            run()
            torch.cuda.synchronize()
            marks = np.zeros(4096, np.uint64)
            if lib.refine_marks(ctypes.c_void_p(marks.ctypes.data)):
                raise RuntimeError("reading the marks failed")
            tiles = -(-H.nsel_cap(OUT) // 16)
            ctas = min(-(-tiles // REFINE_SHAPES["as_is"][0]), REFINE_SHAPES["as_is"][1])
            m = marks.astype(np.int64)[: 6 * ctas].reshape(ctas, 6)
            q = lambda v: [float(x) for x in np.percentile(v, [0, 50, 90, 100])]  # noqa: E731
            last = int(np.argmax(m[:, 4]))
            result[name] = {
                "ctas": ctas, "lengths_us": q((m[:, 1] - m[:, 0]) / 1e3),
                "tiles_us": q((m[:, 2] - m[:, 1]) / 1e3), "sums_us": q((m[:, 3] - m[:, 2]) / 1e3),
                "start_spread_us": float((m[:, 0].max() - m[:, 0].min()) / 1e3),
                "last_cta_fold_us": float((m[last, 4] - m[last, 3]) / 1e3),
                "span_us": float((m[last, 4] - m[:, 0].min()) / 1e3)}
            continue
        prof = kernel_device_us(run)
        result[name] = {"warps_ctas": REFINE_SHAPES.get(name, REFINE_SHAPES["as_is"]),
                        "ms": _ms(run), "device_us": prof["sum_us"],
                        "launches": prof["launches"]}
    return result


def _ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def l2_chase_ns(chase) -> float:
    """ns a dependent load of one thread walking a random cycle of
    900,096 words."""
    n = 900_096
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    nxt = torch.empty(n, dtype=torch.int32)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    nxt = nxt.cuda()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(steps):
        if chase.l2_chase(nxt.data_ptr(), steps, out.data_ptr(), stream):
            raise RuntimeError("the chase kernel did not launch")

    run(n)  # a lap: the words in the L2
    torch.cuda.synchronize()
    t = {steps: _ms(lambda: run(steps), 5) for steps in (10_000, 20_000)}
    return (t[20_000] - t[10_000]) * 1e6 / 10_000


def _inverse(lib, key: int, last: torch.Tensor, n: int):
    """One call of a variant's library: (out, the pinned record)."""
    sizes = (ctypes.c_longlong * 7)()
    if lib.tpubz_ibwt_sizes(n, last.shape[0], sizes):
        raise RuntimeError("sizes refused")
    scratch = torch.empty(sizes[1], dtype=torch.uint8, device=last.device)
    out = torch.empty(n, dtype=torch.uint8, device=last.device)
    pinned = torch.zeros(sizes[2], dtype=torch.int32, pin_memory=True)
    launched = ctypes.c_int(0)
    rc = lib.tpubz_bwt_inverse(last.data_ptr(), key, n, last.shape[0], scratch.data_ptr(),
                               sizes[1], pinned.data_ptr(), out.data_ptr(),
                               ctypes.byref(launched), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"CUDA error {rc}")
    return out, pinned


def timeline(lib, key: int, last: torch.Tensor, n: int) -> dict:
    """One call of the timeline variant after a warm-up: percentiles (0, 50,
    90, 100) of walk_rows', walk_list's and write_orbit's CTA µs and each
    kernel's span, the gaps between the kernels, and rank_top's phases (µs)."""
    lib.ibwt_marks.argtypes = [ctypes.c_void_p]
    lib.ibwt_marks.restype = ctypes.c_int
    for _ in range(2):
        _inverse(lib, key, last, n)
        torch.cuda.synchronize()
    marks = np.zeros(16384, np.uint64)
    if lib.ibwt_marks(ctypes.c_void_p(marks.ctypes.data)):
        raise RuntimeError("reading the marks failed")
    m = marks.astype(np.int64)
    m1 = -(-n >> ibwt.LOG_D[0]) + 1
    m2 = -(-m1 >> ibwt.LOG_D[1]) + 1
    ctas = {"walk_rows": (0, -(-m1 // 256)), "walk_list": (9000, -(-m2 // 256)),
            "write_orbit": (10000, -(-m1 // 256))}  # 256 threads a CTA in each
    q = lambda v: [float(x) for x in np.percentile(v, [0, 50, 90, 100])]  # noqa: E731
    out, spans = {}, {}
    for name, (base, count) in ctas.items():
        pairs = m[base: base + 2 * count].reshape(count, 2)
        out[f"{name}_cta_us"] = q((pairs[:, 1] - pairs[:, 0]) / 1e3)
        spans[name] = (int(pairs[:, 0].min()), int(pairs[:, 1].max()))
        out[f"{name}_span_us"] = (spans[name][1] - spans[name][0]) / 1e3
    top = m[9200:9205]
    out["rank_top_us"] = dict(zip(("load", "walks", "doubling", "offsets"),
                                  (np.diff(top) / 1e3).tolist()))
    out["fill_us"] = float((m[12001] - m[12000]) / 1e3)
    out["gaps_us"] = {"walk_rows_to_walk_list": (spans["walk_list"][0] - spans["walk_rows"][1]) / 1e3,
                      "walk_list_to_rank_top": (int(top[0]) - spans["walk_list"][1]) / 1e3,
                      "rank_top_to_write_orbit": (spans["write_orbit"][0] - int(top[4])) / 1e3}
    return out


def variants(libs: dict, cols: list, blocks: list, chase_ns: float) -> dict:
    from .stage_probe import _span_us, kernel_device_us

    result = {}
    key0, last0, n0 = cols[0]
    for name, lib in libs.items():
        if name == "timeline":
            result[name] = timeline(lib, key0, last0, n0)
            continue
        out, pinned = _inverse(lib, key0, last0, n0)
        torch.cuda.synchronize()
        record = dict(zip(ibwt.RECORD, (int(x) for x in pinned)))
        per_block = []
        for (key, last, n), (blk, _) in zip(cols, blocks):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            got, _ = _inverse(lib, key, last, n)
            b.record()
            b.synchronize()
            per_block.append(a.elapsed_time(b))
            if not np.array_equal(got.cpu().numpy(), blk):
                raise AssertionError(f"variant {name} did not give a {n}-byte block back")
        prof = kernel_device_us(lambda: _inverse(lib, key0, last0, n0))
        span = [_span_us(lambda: _inverse(lib, key0, last0, n0)) for _ in range(5)]
        result[name] = {
            "log_d": DENSITIES[name], "record": record,
            "ms": _ms(lambda: _inverse(lib, key0, last0, n0)),
            "device_us": prof["sum_us"], "device_busy_us": prof["busy_us"],
            "span_us": span,
            "launches": prof["launches"], "kernels_us": prof["kernels_us"],
            "latency_bound_us": (record["longest"] + record["list_longest"]) * chase_ns / 1e3,
            "ms_per_block_median": statistics.median(per_block),
        }
    return result


_TURN = r"""
import inspect, json, statistics, sys, time
import numpy as np, torch
from tpubz_torch.block.encode import DeviceBlockEncoder
from tpubz_torch.format.constants import block_budget
from tpubz_torch.format.crc import block_crc
from tpubz_torch.hostref.huffman import c_init_tables
from tpubz_torch.hostref.rle1 import rle1_blocks
from tpubz_torch.kernels import huffman_dev as H, ibwt
from tpubz_torch.stage_probe import _span_us, _union_us

with open(sys.argv[1], "rb") as f:
    arr = np.frombuffer(f.read(), np.uint8)
rle1, cuts = rle1_blocks(arr, block_budget(9))
blocks = [(rle1[o0:o1], block_crc(arr[i0:i1])) for o0, o1, i0, i1 in cuts]
enc = DeviceBlockEncoder(9)

def ms(fn, reps=20):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); b.synchronize()
    return a.elapsed_time(b) / reps

def device(fn, calls=20):
    # device µs of one call by kernel, their sum and union, and its launches:
    # the mean of `calls` calls under torch.profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + (e.time_range.end - e.time_range.start) / calls
    return {"sum_us": sum(by_name.values()),
            "busy_us": _union_us((e.time_range.start, e.time_range.end) for e in dev) / calls,
            "launches": len(dev) / calls, "kernels_us": by_name}

out = {}
_, syms, rl_d, freqs_d, used_d = enc.transform(blocks[0][0])
freqs, used = freqs_d.cpu().numpy(), used_d.cpu().numpy()
lens = torch.from_numpy(c_init_tables(freqs, 6, int(used.sum()) + 2).astype(np.int32)).cuda()
if "hist" in inspect.signature(H.refine_pass).parameters:  # over the histogram
    hist = H.chunk_hist(syms, rl_d)
    call = lambda: H.refine_pass(hist, lens, 6)
else:
    passes = H.RefinePasses(syms, rl_d)
    passes.lens.copy_(lens)
    call = lambda: passes.launch(6)
out["refine_ms"] = ms(call)
out["refine_device"] = device(call)
out["refine_span_us"] = [_span_us(call) for _ in range(3)]
dev_ms = []
for blk, crc in blocks:
    t = enc.transform(blk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc.encode_block_devrefine(t, crc)
    dev_ms.append((time.perf_counter() - t0) * 1e3)
out["devrefine_host_ms_per_block_median"] = statistics.median(dev_ms)
if hasattr(enc, "devrefine_host_us"):
    u = dict(enc.devrefine_host_us)
    out["devrefine_pass_host_us_mean"] = {k: u[k] / u["passes"] for k in u if k != "passes"}
cols = []
for blk, _ in blocks:
    key, last, n = enc.transform_bwt(blk)
    cols.append((int(key), last, n))
key0, last0, n0 = cols[0]
inv = lambda: ibwt.bwt_inverse_device(key0, last0, n0)
out["inverse_ms"] = ms(inv)
out["inverse_device"] = device(inv)
out["inverse_span_us"] = [_span_us(inv) for _ in range(3)]
per = []
for key, last, n in cols:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    ibwt.bwt_inverse_device(key, last, n)
    b.record(); b.synchronize()
    per.append(a.elapsed_time(b))
out["inverse_ms_per_block_median"] = statistics.median(per)
if hasattr(ibwt, "finish_calls"):
    ibwt.finish_calls()
print("TURN " + json.dumps(out))
"""


def _turn(tree: str, data_path: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", _TURN, data_path], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"the turn in {tree} failed:\n{proc.stderr[-4000:]}")
    line = next(s for s in proc.stdout.splitlines() if s.startswith("TURN "))
    return json.loads(line[5:])


def turns(parent: str, data_path: str, reps: int) -> list[dict]:
    """parent, this, this, parent, ``reps`` times, each a fresh process."""
    order = (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent))
    return [{"tree": name, **_turn(tree, data_path)} for _ in range(reps) for name, tree in order]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--out")
    ap.add_argument("--parent")
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ibwt_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from .block.encode import DeviceBlockEncoder
    from .format.constants import block_budget
    from .hostref.rle1 import rle1_blocks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    data = level9_data(args.mib, args.seed)
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "data": f"with_tied_tail(mixed_corpus({args.mib}, seed={args.seed}) + "
                      f"edge_blocks(), 9)", "bytes": len(data)}
    rle1, cuts = rle1_blocks(np.frombuffer(data, np.uint8), block_budget(9))
    blocks = [(rle1[o0:o1], None) for o0, o1, _, _ in cuts]
    enc = DeviceBlockEncoder(9)
    cols = []
    for blk, _ in blocks:
        key, last, n = enc.transform_bwt(blk)
        cols.append((int(key), last, n))
    with tempfile.TemporaryDirectory() as work:
        libs, refine_libs, chase = build(work)
        result["l2_chase_ns"] = l2_chase_ns(chase)
        result["variants"] = variants(libs, cols, blocks, result["l2_chase_ns"])
        from .hostref.huffman import c_init_tables

        _, syms, rl_d, freqs_d, used_d = enc.transform(blocks[0][0])
        freqs, used = freqs_d.cpu().numpy(), used_d.cpu().numpy()
        lens = c_init_tables(freqs, 6, int(used.sum()) + 2).astype(np.int32)
        result["refine_shapes"] = refine_shapes(refine_libs, syms, rl_d,
                                                torch.from_numpy(lens).cuda())
        if args.parent:
            path = os.path.join(work, "data.bin")
            with open(path, "wb") as f:
                f.write(data)
            result["parent"] = os.path.abspath(args.parent)
            result["turns"] = turns(os.path.abspath(args.parent), path, args.reps)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

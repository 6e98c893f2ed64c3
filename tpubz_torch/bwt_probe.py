"""The BWT's sort and its call held against the alternatives they replaced,
on the card.

    python3 -m tpubz_torch.bwt_probe [--parent DIR] [--variants a,b] [--out FILE]

Needs a CUDA card and nvcc: without a card it exits with code 1. Each
variant is ``csrc/`` built as it is or with one choice undone, by nvcc
(sm_90a) into a library of its own, and run in a fresh process on the same
inputs: the radix sort of the first level-9 block's round-0 keys of
``corpus.mixed_corpus(5, 2026)`` (900,000 keys), the BWT of that block
and the batched BWT of five level-9 rows (that block, the near-periodic
block, ``bytes(range(256)) * 3500``, random bytes, the sidecar overflow
block). Per variant it gives the ms of each call (CUDA events, back to
back), the card's span of one call (CUDA events around it, enqueued behind
device work so that the host's enqueueing is hidden), its device µs by
kernel (``torch.profiler``, one call; it may trace only some of the
iterations of a CUDA graph's loop, so its launch count is beside it), the
batch's mismatches against its plain version, and the block's rounds with
each round's large and small lists. ``--parent DIR`` adds the tree at DIR (a
``git archive`` of an earlier commit) as a variant of its own; the
variants run in turns (each in order, then in reverse). Variants:

- ``as_is``: the sources;
- ``ballot``: a warp's equal digits found by one ballot a digit bit (the
  onesweep match) in place of ``__match_any_sync``;
- ``per8``: 8 keys a thread in a radix pass (tiles of 2048) in place of 16,
  and with it the shared-memory sort's classes of at most 2048 keys (the
  tile) and the large classes' 9-bit ordinals;
- ``no_skip``: no radix pass skipped when one digit holds every key;
- ``count0``: no chunk of small classes placed by counting (every chunk
  through the four shared-memory passes);
- ``no_split``: no small list: from round 1 on every active rotation goes
  through the global passes, keyed by its class's rank, as before the
  shared-memory sort.

It prints one JSON object, also written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MATCH = "  return __match_any_sync(kFull, valid ? d : 0xffffffffu);"
_BALLOT = """  unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned m = __ballot_sync(kFull, bit);
    peers &= bit ? m : ~m;
  }
  return peers;"""
VARIANTS = {
    "as_is": [],
    "ballot": [("radix.cuh", _MATCH, _BALLOT)],
    "per8": [("radix.cuh", "constexpr int kPer = 16;", "constexpr int kPer = 8;"),
             ("bwt.cu", "static_assert(kMaxLarge <= 256, \"a large class's ordinal fits 8 bits\");",
              "static_assert(kMaxLarge <= 512, \"a large class's ordinal fits 9 bits\");")],
    "no_skip": [("bwt.cu", "    if (hist[b] == static_cast<uint32_t>(m)) s_skip = 1;\n", "")],
    "count0": [("bwt.cu", "constexpr int kCountMax = 64;", "constexpr int kCountMax = 0;")],
    # every active rotation on the large list, keyed by its class's rank
    # (no ordinal), so bwt_small_sort always finds its list empty
    "no_split": [
        ("bwt.cu", "      key[j] = (static_cast<int64_t>(e[j] >> kOrdShift) << (2 * kMaxLog2)) |",
         "      key[j] = (static_cast<int64_t>(__ldg(rank + i)) << (2 * kMaxLog2)) |"),
        ("bwt.cu", "    s_large[tt] = large;\n    s_small[tt] = s_act[tt] - large;",
         "    s_large[tt] = s_act[tt];\n    s_small[tt] = 0;"),
        ("bwt.cu", "(size[q] > kSmallTile ? my_large : my_small) += 1;", "my_large += 1;"),
        ("bwt.cu", "        if (size[q] > kSmallTile) {", "        if (true) {"),
        ("bwt.cu", "          if (idx == headq) next_table[ord] = g + headq - first;\n"
         "          o = out_large++ | (ord << kOrdShift);", "          o = out_large++ + 0 * ord;"),
        ("bwt.cu", "idx < ml ? table[k >> (2 * kMaxLog2)] : static_cast<int>(k >> (2 * kMaxLog2))",
         "static_cast<int>(k >> (2 * kMaxLog2))")],
}

# runs in a fresh process: argv = csrc dir, build dir, tree root
_CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[3])
from tpubz_torch.kernels import _build
_build.CSRC_DIR, _build.BUILD_DIR = sys.argv[1], sys.argv[2]
_build.LIB_PATH = sys.argv[2] + "/lib.so"
from tpubz_torch import stage_probe as sp
from tpubz_torch.corpus import edge_blocks, mixed_corpus, sidecar_overflow_block
from tpubz_torch.kernels import radix, suffix_sort

dev = torch.device("cuda")


def ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def profiled(fn):
    p = sp.kernel_device_us(fn)
    return {"device_us": p["sum_us"], "launches": p["launches"],
            "by_kernel": {k: v["us"] for k, v in sp._by_kernel(p).items()}}


# the card's µs from the call's first operation to its last: events around
# one call enqueued behind tens of ms of device work, so that the host's
# enqueueing is hidden (a wrapper that waits inside the call shows its
# waits as idle time in the span)
def span_us(fn):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    held = fn()  # an unfinished call waits when it is dropped: after b
    b.record()
    b.synchronize()
    del held
    return a.elapsed_time(b) * 1e3


corpus = mixed_corpus(5, 2026)
n0, N = 900_000, 900_096
pad = torch.zeros(N, dtype=torch.uint8, device=dev)
pad[:n0] = torch.frombuffer(bytearray(corpus[:n0]), dtype=torch.uint8).to(dev)
out = {}
k0 = suffix_sort.round_keys(pad[:n0], 0)
out["radix"] = {"ms": ms(lambda: radix.radix_sort(k0, 20, 60)),
                **profiled(lambda: radix.radix_sort(k0, 20, 60))}
one = getattr(suffix_sort, "bwt_forward_async", suffix_sort.bwt_forward)
out["bwt"] = {"ms": ms(lambda: suffix_sort.bwt_forward(pad, n0)),
              "span_us": span_us(lambda: one(pad, n0)),
              **profiled(lambda: suffix_sort.bwt_forward(pad, n0))}
if hasattr(suffix_sort, "bwt_forward_async"):
    _, _, call = suffix_sort.bwt_forward_async(pad, n0)
    call.finish()
    words = call.rows[0]["words"]
    out["bwt"]["large_by_round"] = [n0] + [int(w[3]) for w in words[:-1]]
    out["bwt"]["small_by_round"] = [0] + [int(w[0] - w[3]) for w in words[:-1]]
    out["bwt"]["passes_skipped"] = call.rows[0]["skipped"]
    out["bwt"]["record"] = {k: v for k, v in call.rows[0].items() if k != "words"}
edges = edge_blocks()
rng = np.random.default_rng(2026)
rows = [corpus[:n0], edges["near_periodic"], edges["all256"], rng.bytes(899_001),
        sidecar_overflow_block()]
data = torch.zeros(len(rows), N, dtype=torch.uint8)
for b, r in enumerate(rows):
    data[b, : len(r)] = torch.frombuffer(bytearray(r), dtype=torch.uint8)
data, n = data.to(dev), [len(r) for r in rows]
keys, last = suffix_sort.bwt_forward_batch(data, n)
rkeys, rlast = suffix_sort.bwt_forward_batch_ref(data, n)
out["batch"] = {"ms": ms(lambda: suffix_sort.bwt_forward_batch(data, n), 5),
                "span_us": span_us(lambda: suffix_sort.bwt_forward_batch(data, n)),
                "mismatches": int((keys != rkeys).sum()) + int((last != rlast).sum()),
                **profiled(lambda: suffix_sort.bwt_forward_batch(data, n))}
print("RESULT " + json.dumps(out))
"""


def variant_csrc(root: str, edits, work: str) -> str:
    """A copy of root's csrc/ with the edits; an edit whose text the source
    no longer holds raises: the probe follows the source."""
    src = os.path.join(work, "csrc")
    shutil.copytree(os.path.join(root, "tpubz_torch", "csrc"), src)
    for name, old, new in edits:
        path = os.path.join(src, name)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in the source")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return src


def run_variant(name: str, root: str, edits) -> dict:
    with tempfile.TemporaryDirectory() as work:
        src = variant_csrc(root, edits, work)
        build = os.path.join(work, "build")
        os.makedirs(build)
        proc = subprocess.run([sys.executable, "-c", _CHILD, src, build, root], cwd=root,
                              env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                              text=True, timeout=900)
    line = [s for s in proc.stdout.splitlines() if s.startswith("RESULT ")]
    if proc.returncode != 0 or not line:
        raise RuntimeError(f"variant {name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(line[0][7:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another tree, run as the variant 'parent'")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bwt_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    plan = [(name, ROOT, VARIANTS[name]) for name in args.variants.split(",")]
    if args.parent:
        plan.insert(0, ("parent", os.path.abspath(args.parent), []))
    turns = []
    for order in (plan, plan[::-1]):
        for name, root, edits in order:
            turns.append({"variant": name, **run_variant(name, root, edits)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "turns": turns}
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The bitonic sort on the card: its launch-plan shapes, and this tree against
another checkout of the port, in turns.

    python3 -m tpubz_torch.sort_probe [--parent DIR] [--reps 2] [--out FILE]

Needs a CUDA card: without one it exits with code 1. Prints one JSON
object, also written to ``--out``:

- ``sweep``: for each tile (2^12, 2^13, 2^14 keys), elements a thread
  holds (2^3, 2^4) and fuse width (3, 4, 5 passes a global launch), the
  device ms of ``bitonic_2op`` and
  ``bitonic_1op`` on the int64 keys of a level-9 block's first doubling
  round (2^20, as the BWT sorts them) and of ``bitonic_2op`` on int32 keys
  with duplicates, the kernel launches per sort, and whether each output
  equals the default plan's; ``torch.sort`` on the same keys in the same
  turn. CUDA events, mean over 20 sorts after a warm-up, in the L2.
- ``profile``: each kernel launch of one default-plan ``bitonic_2op`` and
  ``bitonic_1op`` on those int64 keys, in order, with its device
  microseconds from ``torch.profiler`` and the plan's record of it.
- ``anatomy``: device ms of one launch on the same int64 keys and int32
  payload, from a plan of 20 copies of it in one library call (one host
  call, so the card runs them back to back); each a hand-made launch: a tile launch of one group (one
  pass, or four) with high register bits (the lanes walk consecutive keys)
  or low ones (a thread holds consecutive keys), two and four groups of one
  pass (one and three trips through shared memory), a stage's real merge,
  and global launches of 1 and 4 passes.
- ``turns``: with ``--parent``, the same default-plan sort times, the
  launches per sort, and ``stage_probe.bwt_stage_times`` per level-9 block
  of the seeded corpus (``mixed_corpus(16, 2026)`` plus the edge blocks),
  each from a fresh process of the parent's tree and of this one, in the
  order parent, this, this, parent, ``--reps`` times. The parent is any
  checkout of the port with ``tpubz_torch/kernels/bitonic.py``, such as a
  ``git archive`` of an earlier commit unpacked into a directory that
  ``.gitignore`` lists.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2026

# runs in a fresh process in either tree: only names both trees define
_TURN = r"""
import json, sys, time
import numpy as np
import torch
from tpubz_torch.corpus import edge_blocks, mixed_corpus
from tpubz_torch.kernels import bitonic
from tpubz_torch.stage_probe import bwt_stage_times

def ms(fn, reps=20):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); b.synchronize()
    return a.elapsed_time(b) / reps

def launches(fn):
    before = bitonic.PASS_LAUNCHES
    fn(); torch.cuda.synchronize()
    return bitonic.PASS_LAUNCHES - before

corpus = mixed_corpus(16, SEED)
dev = torch.device("cuda")
n0 = 900_000
padded = torch.zeros(1 << 20, dtype=torch.uint8, device=dev)
padded[:n0] = torch.frombuffer(bytearray(corpus[:n0]), dtype=torch.uint8).to(dev)
# the BWT's round-0 keys of the block, built here from the bytes (five
# cyclic bytes << 20 | position), padded with INT64_MAX: both trees run it
blk = padded[:n0].long()
at = torch.arange(n0, device=dev)
packed = torch.zeros(n0, dtype=torch.int64, device=dev)
for q in range(5):
    packed = (packed << 8) | blk[(at + q) % n0]
k64 = torch.full((1 << 20,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
k64[:n0] = (packed << 20) | at
pos = torch.arange(1 << 20, dtype=torch.int32, device=dev)
rng = np.random.default_rng(SEED)
k32 = torch.from_numpy(rng.integers(0, 50, 1 << 20).astype(np.int32)).to(dev)
p32 = torch.from_numpy(rng.permutation(1 << 20).astype(np.int32)).to(dev)
out = {
    "2op_i64_ms": ms(lambda: bitonic.bitonic_2op(k64, pos)),
    "1op_i64_ms": ms(lambda: bitonic.bitonic_1op(k64)),
    "2op_i32_ms": ms(lambda: bitonic.bitonic_2op(k32, p32)),
    "torch_sort_i64_ms": ms(lambda: torch.sort(k64)),
    "launches_2op": launches(lambda: bitonic.bitonic_2op(k64, pos)),
    "launches_1op": launches(lambda: bitonic.bitonic_1op(k64)),
    "bwt_stages": bwt_stage_times(corpus + b"".join(edge_blocks().values()), 9, "cuda"),
}
print("TURN " + json.dumps(out))
""".replace("SEED", str(SEED))

SHAPES = ((12, 3), (12, 4), (13, 3), (13, 4), (14, 4))
FUSES = (3, 4, 5)


def _cuda_ms(fn, reps=20):
    import torch

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


def _bwt_keys(block):
    """The BWT's round-0 keys of a block (suffix_sort.round_keys), padded to
    2^20 with INT64_MAX for the bitonic sorts."""
    import torch

    from .kernels import suffix_sort

    keys = torch.full((1 << 20,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=block.device)
    keys[: block.shape[0]] = suffix_sort.round_keys(block, 0)
    return keys


def sweep() -> list[dict]:
    """Sort ms and launches per plan shape, each output held against the
    default plan's."""
    import numpy as np
    import torch

    from .corpus import mixed_corpus
    from .kernels import bitonic

    dev = torch.device("cuda")
    n0 = 900_000
    padded = torch.zeros(1 << 20, dtype=torch.uint8, device=dev)
    padded[:n0] = torch.frombuffer(bytearray(mixed_corpus(1, SEED)[:n0]), dtype=torch.uint8).to(dev)
    k64 = _bwt_keys(padded[:n0])
    pos = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(SEED)
    k32 = torch.from_numpy(rng.integers(0, 50, 1 << 20).astype(np.int32)).to(dev)
    p32 = torch.from_numpy(rng.permutation(1 << 20).astype(np.int32)).to(dev)
    runs = {
        "2op_i64": lambda: bitonic.bitonic_2op(k64, pos),
        "1op_i64": lambda: bitonic.bitonic_1op(k64),
        "2op_i32": lambda: bitonic.bitonic_2op(k32, p32),
    }
    want = {name: run() for name, run in runs.items()}
    saved = (bitonic.TILE_LOG2, bitonic.REGS_LOG2, bitonic.FUSE)
    rows = []
    try:
        for tile_log2, regs_log2 in SHAPES:
            for fuse in FUSES:
                bitonic.TILE_LOG2, bitonic.REGS_LOG2, bitonic.FUSE = tile_log2, regs_log2, fuse
                row = {"tile_log2": tile_log2, "regs_log2": regs_log2, "fuse": fuse}
                for name, run in runs.items():
                    before = bitonic.PASS_LAUNCHES
                    got = run()
                    torch.cuda.synchronize()
                    row[f"launches_{name}"] = bitonic.PASS_LAUNCHES - before
                    got = got if isinstance(got, tuple) else (got,)
                    ref = want[name] if isinstance(want[name], tuple) else (want[name],)
                    row[f"equal_{name}"] = all(torch.equal(g, r) for g, r in zip(got, ref))
                    row[f"{name}_ms"] = _cuda_ms(run)
                row["torch_sort_i64_ms"] = _cuda_ms(lambda: torch.sort(k64))
                rows.append(row)
    finally:
        bitonic.TILE_LOG2, bitonic.REGS_LOG2, bitonic.FUSE = saved
    return rows


def profile() -> dict:
    """Device microseconds of each launch of one default-plan sort."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from .corpus import mixed_corpus
    from .kernels import bitonic

    dev = torch.device("cuda")
    n0 = 900_000
    padded = torch.zeros(1 << 20, dtype=torch.uint8, device=dev)
    padded[:n0] = torch.frombuffer(bytearray(mixed_corpus(1, SEED)[:n0]), dtype=torch.uint8).to(dev)
    k64 = _bwt_keys(padded[:n0])
    pos = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    launches = bitonic.plan(bitonic.network(20), 20)
    records = [x[:4] if x[0] == "global" else ("tile", x[1], x[2], len(x[3])) for x in launches]
    out = {"plan": records}
    for name, run in (("2op_i64", lambda: bitonic.bitonic_2op(k64, pos)),
                      ("1op_i64", lambda: bitonic.bitonic_1op(k64))):
        run()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and "bitonic" in e.name), key=lambda e: e.time_range.start)
        out[name] = [{"kernel": re.sub(r"\(.*", "", e.name.split("::")[-1]),
                      "us": e.time_range.end - e.time_range.start} for e in evs]
    return out


REPEAT = 20


def anatomy(tile_log2: int = 13, regs_log2: int = 4) -> dict:
    """Device ms of hand-made single-launch plans (see the module doc)."""
    import ctypes

    import torch

    from .corpus import mixed_corpus
    from .kernels import bitonic

    dev = torch.device("cuda")
    n0 = 900_000
    padded = torch.zeros(1 << 20, dtype=torch.uint8, device=dev)
    padded[:n0] = torch.frombuffer(bytearray(mixed_corpus(1, SEED)[:n0]), dtype=torch.uint8).to(dev)
    k64 = _bwt_keys(padded[:n0])
    pos = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    t, R = tile_log2, regs_log2
    high = tuple(range(t - R, t))
    low = tuple(range(R))
    mid = (4, 5, 6, 7)
    k = 20
    merge = bitonic.plan([(k, j) for j in range(t - 1, -1, -1)], 20, t, R)
    cases = {
        "tile_1group_high_1pass": [("tile", t, R, [(high, [(k, t - 1)])])],
        "tile_1group_high_4pass": [("tile", t, R, [(high, [(k, j) for j in high[::-1]])])],
        "tile_1group_low_1pass": [("tile", t, R, [(low, [(k, 0)])])],
        "tile_1group_low_4pass": [("tile", t, R, [(low, [(k, j) for j in low[::-1]])])],
        "tile_1group_mid_1pass": [("tile", t, R, [(mid, [(k, 4)])])],
        "tile_2groups_high_low": [("tile", t, R, [(high, [(k, t - 1)]), (low, [(k, 0)])])],
        "tile_4groups_1pass_each": [("tile", t, R, [(high, [(k, t - 1)]), (high, [(k, t - 2)]),
                                                     (mid, [(k, 4)]), (low, [(k, 0)])])],
        "tile_1group_high_16pass": [("tile", t, R, [(high, [(k, j) for j in high[::-1]] * 4)])],
        "tile_1group_low_16pass": [("tile", t, R, [(low, [(k, j) for j in low[::-1]] * 4)])],
        "tile_merge": merge,
        "global_1pass": [("global", k, 19, 1)],
        "global_4pass": [("global", k, 16, 4)],
    }
    out = {}
    for name, launches in cases.items():
        words = bitonic.encode(launches * REPEAT)
        arr = ((ctypes.c_int * len(words))(*words), len(words))
        keys, pay = k64.clone(), pos.clone()
        out[name] = _cuda_ms(lambda: bitonic._launch("bitonic_2op", keys, pay, arr), 5) / REPEAT
    return out


def _turn(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", _TURN], cwd=tree, env=env, capture_output=True,
                          text=True, timeout=900, check=True)
    line = next(s for s in proc.stdout.splitlines() if s.startswith("TURN "))
    return json.loads(line[5:])


def turns(parent: str, reps: int) -> list[dict]:
    """parent, this, this, parent, ``reps`` times, each a fresh process."""
    out = []
    for _ in range(reps):
        for name, tree in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
            out.append({"tree": name, **_turn(tree)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sort_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "sweep": sweep(), "profile": profile(), "anatomy": anatomy()}
    if args.parent:
        result["parent"] = os.path.abspath(args.parent)
        result["turns"] = turns(os.path.abspath(args.parent), args.reps)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

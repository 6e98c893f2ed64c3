"""The control of ``correct``: the plain reference in the program's place,
with one guarantee of the configuration broken, must read as not correct.

The configuration states the port's stream, whose Huffman refinement runs
up to ``huffman_iters`` (8) passes; the control writes C bzip2's own 4
(still a valid bzip2 stream, and the step that would tempt a change that
wants emission cheaper). It runs the harness's whole run of a cell with the
control as the timed path, a short window at the cell's own sizes, on each
seed given, and prints per seed what the harness compared:

    python3 -m bzbench.control --workload bz9-card.history-32m --seeds 1,2,3 --seconds 5

The benchmark's own runs never run it. A stream of the control is made once
per pool file and handed back on each later request for that file, so the
window compares as many streams as a run of the program does.
"""
from __future__ import annotations

import argparse
import json
import sys

from bzbench import reference, run

CONTROL_ITERS = 4


def control(iters: int = CONTROL_ITERS):
    """A ``run_cell`` wrap: the reference with ``iters`` refinement passes
    in place of the program."""
    made: dict[int, bytes] = {}

    def wrap(_compress):
        def compress(data, level, device):
            key = id(data)
            if key not in made:
                made[key] = reference.compress(data, level, iters=iters)
            return made[key]
        return compress
    return wrap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.run_cell(args.workload, seed, args.seconds, False, wrap=control())
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

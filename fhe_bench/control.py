"""Readings for the limits of a cell's compared numbers: the program's own
over many seeds, or the control's, in one process.

    python3 -m fhe_bench.control --workload <cell> --seconds <s> \
        --seeds 1 2 3 [--control]

For each seed it makes a whole run of the cell as ``fhe_bench.run`` does
(set-up, warm-up, a closed-loop window of `--seconds`, the check against
the plain reference, the verdict against the cell's limits) and prints one
JSON line with ``correct`` and each number compared. ``--control`` puts the
cell's control (its file's ``"control"``) in the program's place: for CKKS
the plain reference computing the slots in complex64 (float32) where the
configuration states float64 slots, for BINFHE the program with the
configuration's gadget base one digit coarser. The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from fhe_bench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fhe_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", t,
                             control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          **{k: v["value"] for k, v in r["compared"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

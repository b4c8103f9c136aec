#!/usr/bin/env python3
"""The readings that the check's limits are set from: for each seed, one
short run of the cell (the program's numbers against the reference) and,
with `--control`, the control's numbers on the same sample (the reference
in the next precision down, put in the program's place); with `--fault`,
those of the fault that the cell's traffic driver plants (the batched
cells: the last AL iteration's step not taken).  All seeds in one
process, so that set-up and the kernels' build are paid once.

    python3 benchmark/readings.py --workload <name> --seconds <s> \
        --seeds 1 2 3 [--control] [--fault]

Prints one JSON line per seed (`seed`, `compared`, `numbers`,
`control_numbers`, `fault_numbers`, `checks`, `metrics`, `attempted`,
`failed`, `run_s`).  The benchmark's own runs never run the control or
the fault.
"""
import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="store_true")
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.HERE.parent, args.workload)
    log = (lambda msg: print(msg, file=sys.stderr, flush=True))
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, t0,
                             control=args.control, fault=args.fault,
                             log=log)
        print(json.dumps(dict(
            seed=seed, compared=r["compared"], numbers=r.get("numbers"),
            control_numbers=r.get("control_numbers"),
            fault_numbers=r.get("fault_numbers"), checks=r["checks"],
            metrics=r["metrics"],
            attempted=r["attempted"], failed=r["failed"],
            run_s=time.perf_counter() - t0), default=str), flush=True)
    bad = harness.forbidden_modules()
    if bad:
        log(f"readings: the process loaded {', '.join(bad)}")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

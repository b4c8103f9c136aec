#!/usr/bin/env python3
"""Run one cell of the benchmark of `cafempc_tpu_torch` once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints, as its last line, one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, and with
`--trace 1` `breakdown`, then `checks`); exits non-zero with no result
where the cell's CUDA devices are missing or the run loaded JAX or the
JAX package.  See benchmark/harness.py.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root in place of this script's directory, so that the
# benchmark's modules load as the `benchmark` package and shadow nothing
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))

"""`hsddp.select_skip_pct`: the share of the leaves handed to the
solver's per-scenario selects (`tree_where`) that were passed through
without a launch, read from the program's own `hsddp.select_skip` and
`hsddp.select_copy` counters (kept per root span):
100 * skip / (skip + copy) per window solve, mean over the window's
solves.  None on a program without those counters."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    buf = _base.buffer()
    units = None if buf is None else _base.window(rec, buf[0])
    if units is None:
        return None
    shares = []
    for u in units:
        per = buf[1].get(u, {})
        skip = per.get("hsddp.select_skip")
        copy = per.get("hsddp.select_copy")
        if skip is None or copy is None or skip + copy == 0:
            return None
        shares.append(100.0 * skip / (skip + copy))
    return _base.per_unit(rec, shares)

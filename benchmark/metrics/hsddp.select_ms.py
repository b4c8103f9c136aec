"""`hsddp.select_ms`: stream ms a window solve spends in the solver's
per-scenario selects: the CUDA event pairs of its `hsddp.select` spans
(one a `tree_where` call), summed, mean over the window's solves."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    return _base.span_sums(rec, ("hsddp.select",), "device_ms")

"""`hsddp.lq_ms`: stream ms a window solve spends in the LQ stage, from
the CUDA event pairs of the solver's own `hsddp.lq` spans (around
`lq_approx` or the fused LQ hook), summed, mean over the window's
solves."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    return _base.span_sums(rec, ("hsddp.lq",), "device_ms")

"""`br.wb.ad_ms`: stream ms a window barrel-roll solve spends in the
whole-body dynamics partials by forward-mode AD, from the CUDA event
pairs of the program's `wbm.ad_partials` spans (`models/wbm.py`, around
the Jacobian of `dynamics_partials`), summed, mean over the window's
solves."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    return _base.span_sums(rec, ("wbm.ad_partials",), "device_ms")

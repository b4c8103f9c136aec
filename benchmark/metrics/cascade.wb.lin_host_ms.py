"""`cascade.wb.lin_host_ms`: host ms a window cascade solve spends in the
whole-body linearization: the host clocks of its `wb.partials` and
`wb.impulse_partials` spans (`models/wb_lane.py`), summed, mean over the
window's solves.  Beside the LQ stage's stream ms it says whether the
host waited there or was still dispatching."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    return _base.span_sums(rec, ("wb.partials", "wb.impulse_partials"),
                           "host_ms")

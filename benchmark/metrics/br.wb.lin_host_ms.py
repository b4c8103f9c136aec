"""`br.wb.lin_host_ms`: host ms a window barrel-roll solve spends in the
whole-body linearization: the host clocks of its `wb.partials` and
`wb.impulse_partials` spans (`models/wb_lane.py`, the closed-form
factored-KKT partials of the dynamics and of the impulse reset), summed,
mean over the window's solves, as `cascade.wb.lin_host_ms` reads them in
the cascade cell.  A program whose barrel roll takes its partials by
forward-mode AD records no such span and reads None."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    return _base.span_sums(rec, ("wb.partials", "wb.impulse_partials"),
                           "host_ms")

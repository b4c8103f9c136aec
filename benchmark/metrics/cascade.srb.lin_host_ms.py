"""`cascade.srb.lin_host_ms`: host ms a window cascade solve spends in the
SRB tail's linearization: the host clocks of its `srb.partials` spans
(`problems/mhpc_problem.py`, around the SRB segment's forward-mode
Jacobian), summed, mean over the window's solves.  Beside
`cascade.wb.lin_host_ms` it gives the SRB tail's share of the LQ stage.
A program without the span reads None."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    return _base.span_sums(rec, ("srb.partials",), "host_ms")

"""`cascade.srb.step_host_ms`: host ms a window cascade solve spends in the
SRB tail's forward step: the host clocks of its `srb.step` spans
(`problems/mhpc_problem.py`, around the SRB segment's dynamics, which the
rollouts and the line search's trials call), summed, mean over the
window's solves.  A program without the span reads None."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    return _base.span_sums(rec, ("srb.step",), "host_ms")

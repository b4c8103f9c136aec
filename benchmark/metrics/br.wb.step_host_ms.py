"""`br.wb.step_host_ms`: host ms a window barrel-roll solve spends in the
whole-body forward step: the host clocks of its `wb.step` spans
(`models/wb_lane.py`, around the lane dynamics step and the lane impulse
reset that the trial rollouts call), summed, mean over the window's
solves.  A program whose barrel roll steps with the AD forward dynamics
records no such span and reads None."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    return _base.span_sums(rec, ("wb.step",), "host_ms")

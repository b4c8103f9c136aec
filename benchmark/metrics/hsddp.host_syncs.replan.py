"""`hsddp.host_syncs.replan`: `hsddp.host_syncs` in the replan cell, a
median over its window's updates, where it moves `replan_ms_p50`: the
same reader."""
from pathlib import Path

from benchmark.harness import load_module

_twin = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_twin_hsddp_host_syncs")
WRAPPERS, read = _twin.WRAPPERS, _twin.read

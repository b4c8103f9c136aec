"""`cascade.hsddp.host_syncs`: `hsddp.host_syncs` in the cascade's
batched cell, where it moves `solves_per_s.cascade`: the same reader."""
from pathlib import Path

from benchmark.harness import load_module

_twin = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_twin_hsddp_host_syncs")
WRAPPERS, read = _twin.WRAPPERS, _twin.read

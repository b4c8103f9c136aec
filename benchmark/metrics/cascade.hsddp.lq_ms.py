"""`cascade.hsddp.lq_ms`: `hsddp.lq_ms` in the cascade's batched cell,
where it moves `solves_per_s.cascade`: the same reader."""
from pathlib import Path

from benchmark.harness import load_module

_twin = load_module(Path(__file__).with_name("hsddp.lq_ms.py"),
                    "benchmark_metric_twin_hsddp_lq_ms")
WRAPPERS, read = _twin.WRAPPERS, _twin.read

"""`cascade.sweep_roofline`: `sweep_roofline` in the cascade's batched
cell, where it moves `solves_per_s.cascade`: the same reader."""
from pathlib import Path

from benchmark.harness import load_module

_twin = load_module(Path(__file__).with_name("sweep_roofline.py"),
                    "benchmark_metric_twin_sweep_roofline")
WRAPPERS, read = _twin.WRAPPERS, _twin.read

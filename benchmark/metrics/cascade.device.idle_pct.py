"""`cascade.device.idle_pct`: `device.idle_pct.batched` in the cascade's
batched cell, where it moves `solves_per_s.cascade`: the same reader."""
from pathlib import Path

from benchmark.harness import load_module

_twin = load_module(Path(__file__).with_name("device.idle_pct.batched.py"),
                    "benchmark_metric_twin_device_idle_pct_batched")
WRAPPERS, read = _twin.WRAPPERS, _twin.read

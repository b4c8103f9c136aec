"""`cascade.device.launches`: `device.launches.batched` in the cascade's
batched cell, where it moves `solves_per_s.cascade`: the same reader."""
from pathlib import Path

from benchmark.harness import load_module

_twin = load_module(Path(__file__).with_name("device.launches.batched.py"),
                    "benchmark_metric_twin_device_launches_batched")
WRAPPERS, read = _twin.WRAPPERS, _twin.read

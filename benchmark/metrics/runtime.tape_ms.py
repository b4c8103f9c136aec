"""`runtime.tape_ms`: host ms of the runtime's `runtime.tape` stage (foot
placement, solver-info publish, command tape) an update, median over the
window's updates: the part of an update that the runtime's `timing`
leaves out."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    return _base.span_sums(rec, ("runtime.tape",), "host_ms")

"""`br.wb.ad_host_ms`: host ms of the same `wbm.ad_partials` spans as
`br.wb.ad_ms`, summed, mean over the window's solves.  Beside the stream
ms it says whether the host was dispatching the AD linearization or
waiting on the device."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    return _base.span_sums(rec, ("wbm.ad_partials",), "host_ms")

"""`br.wb.ad_share_pct`: the share of the LQ stage that the whole-body AD
linearization takes: 100 x the stream ms of the `wbm.ad_partials` spans
over those of the solver's `hsddp.lq` spans (which hold them), each a
mean over the window's solves."""
from pathlib import Path

from benchmark.harness import load_module

_base = load_module(Path(__file__).with_name("hsddp.host_syncs.py"),
                    "benchmark_metric_base_hsddp_host_syncs")
WRAPPERS = _base.WRAPPERS


def read(rec):
    ad = _base.span_sums(rec, ("wbm.ad_partials",), "device_ms")
    lq = _base.span_sums(rec, ("hsddp.lq",), "device_ms")
    if ad is None or not lq:
        return None
    return 100.0 * ad / lq

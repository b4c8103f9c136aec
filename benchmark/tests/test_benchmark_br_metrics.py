"""The readers of the barrel-roll cell's AD-linearization spans
(`br.wb.ad_ms`, `br.wb.ad_host_ms`, `br.wb.ad_share_pct`) on synthetic
tracer buffers, as `test_benchmark_program_metrics.py` reads the others:
the window's solves only, their means, the share of the LQ stage, and
None where nothing was traced (a program without the `wbm.ad_partials`
span, as before the span existed, or CPU spans without device ms)."""
import sys

import pytest

from benchmark import harness
from cafempc_tpu_torch import utils
from cafempc_tpu_torch.utils import tracing
from test_benchmark_program_metrics import Buffer

NEW = ("br.wb.ad_ms", "br.wb.ad_host_ms", "br.wb.ad_share_pct")


def load(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "t_br_" + name.replace(".", "_"))


@pytest.fixture
def readers():
    yield {n: load(n) for n in NEW}
    tracing.disable()
    tracing.reset()


def solves(buf, ad=True):
    """2 warm-up and 3 window solves; window solve i has two AD partials
    of 10 + i and 2 stream ms (host 20 + i and 1 ms), an impact partial
    and an LQ stage of 40 + 2 i ms."""
    def solve(i):
        kids = [("hsddp.lq", 40.0 + 2 * i, 50.0),
                ("wbm.impact_partial", 3.0, 3.0), ("br.td_con", 1.0, 1.0)]
        if ad:
            kids += [("wbm.ad_partials", 10.0 + i, 20.0 + i),
                     ("wbm.ad_partials", 2.0, 1.0)]
        buf.unit("hsddp.solve", kids, syncs=5)
    for i in (100, 200):
        solve(i)
    for i in range(3):
        solve(i)
    return dict(n_solves=3, profile=dict(n_units=1))


def test_the_window_means_and_the_share(readers, monkeypatch):
    buf = Buffer()
    rec = solves(buf)
    buf.install(monkeypatch)
    ad, host, lq = 13.0, 22.0, 42.0
    assert readers["br.wb.ad_ms"].read(rec) == pytest.approx(ad)
    assert readers["br.wb.ad_host_ms"].read(rec) == pytest.approx(host)
    assert readers["br.wb.ad_share_pct"].read(rec) == pytest.approx(
        100.0 * ad / lq)
    assert all(readers[n].WRAPPERS == ("profile",) for n in NEW)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_reads_none(readers, monkeypatch, name):
    """An empty buffer, a record without its window, a program without
    the AD span, CPU spans without device ms, and a program without the
    tracer: None."""
    rec = dict(n_solves=3, profile=dict(n_units=1))
    Buffer().install(monkeypatch)
    for r in (rec, {}):
        assert readers[name].read(r) is None
    buf = Buffer()
    solves(buf, ad=False)
    buf.install(monkeypatch)
    assert readers[name].read(rec) is None
    buf = Buffer()
    for _ in range(3):
        buf.unit("hsddp.solve", [("hsddp.lq", None, 5.0),
                                 ("wbm.ad_partials", None, 2.0)])
    buf.install(monkeypatch)
    if name != "br.wb.ad_host_ms":
        assert readers[name].read(rec) is None
    with monkeypatch.context() as m:
        m.delattr(utils, "tracing")
        m.setitem(sys.modules, "cafempc_tpu_torch.utils.tracing", None)
        assert load(name).read(rec) is None

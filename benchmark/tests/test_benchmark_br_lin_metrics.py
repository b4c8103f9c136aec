"""The reader of the barrel-roll cell's closed-form WB linearization
(`br.wb.lin_host_ms`) on synthetic tracer buffers, as
`test_benchmark_br_metrics.py` reads the AD spans: the window's solves
only, the sum of the `wb.partials` and `wb.impulse_partials` host ms a
solve, their mean, and None where nothing was traced (a program whose
barrel roll takes its partials by AD, or one without the tracer)."""
import sys

import pytest

from benchmark import harness
from cafempc_tpu_torch import utils
from cafempc_tpu_torch.utils import tracing
from test_benchmark_program_metrics import Buffer

NAME = "br.wb.lin_host_ms"


def load():
    return harness.load_module(harness.HERE / "metrics" / f"{NAME}.py",
                               "t_br_lin_" + NAME.replace(".", "_"))


@pytest.fixture
def reader():
    yield load()
    tracing.disable()
    tracing.reset()


def solves(buf, cf=True):
    """2 warm-up and 3 window solves; window solve i has four dynamics
    linearizations of 5 + i host ms (3 stream ms) and four impulse ones
    of 1 host ms, beside an LQ stage and the touchdown constraint (or,
    cf=False, AD partials in their place)."""
    def solve(i):
        kids = [("hsddp.lq", 40.0, 50.0), ("br.td_con", 1.0, 1.0)]
        for _ in range(4):
            kids += ([("wb.partials", None, 5.0 + i),
                      ("wb.impulse_partials", None, 1.0)] if cf else
                     [("wbm.ad_partials", 3.0, 5.0 + i),
                      ("wbm.impact_partial", 1.0, 1.0)])
        buf.unit("hsddp.solve", kids, syncs=5)
    for i in (100, 200):
        solve(i)
    for i in range(3):
        solve(i)
    return dict(n_solves=3, profile=dict(n_units=1))


def test_the_window_mean_of_the_sums(reader, monkeypatch):
    """Each window solve sums to 4 x (5 + i) + 4 x 1 ms; the mean over
    i = 0, 1, 2 is 28 ms, the warm-up solves left out."""
    buf = Buffer()
    rec = solves(buf)
    buf.install(monkeypatch)
    assert reader.read(rec) == pytest.approx(28.0)
    assert reader.WRAPPERS == ("profile",)


def test_one_solve_window(reader, monkeypatch):
    """A window of the last solve alone: its own sum."""
    buf = Buffer()
    solves(buf)
    buf.install(monkeypatch)
    assert reader.read(dict(n_solves=1, profile=dict(n_units=1))) \
        == pytest.approx(4 * 7.0 + 4 * 1.0)


def test_nothing_to_read_reads_none(reader, monkeypatch):
    """An empty buffer, a record without its window, a window longer
    than the solves recorded, a program whose barrel roll takes AD
    partials, and a program without the tracer: None."""
    rec = dict(n_solves=3, profile=dict(n_units=1))
    Buffer().install(monkeypatch)
    for r in (rec, {}):
        assert reader.read(r) is None
    buf = Buffer()
    solves(buf)
    buf.install(monkeypatch)
    assert reader.read(dict(n_solves=9, profile=dict(n_units=1))) is None
    buf = Buffer()
    solves(buf, cf=False)
    buf.install(monkeypatch)
    assert reader.read(rec) is None
    with monkeypatch.context() as m:
        m.delattr(utils, "tracing")
        m.setitem(sys.modules, "cafempc_tpu_torch.utils.tracing", None)
        assert load().read(rec) is None

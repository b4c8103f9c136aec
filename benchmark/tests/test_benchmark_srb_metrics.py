"""The readers of the cascade's SRB tail, `cascade.srb.lin_host_ms`
(`srb.partials` spans) and `cascade.srb.step_host_ms` (`srb.step`
spans), as `test_benchmark_br_step_metrics.py` reads the WB step: on
synthetic tracer buffers, the window's solves only, the sum of the span's
host ms a solve and their mean, and None where nothing was traced (a
program without the SRB spans, or one without the tracer); and on a
buffer the program itself recorded, the sum of its spans."""
import sys

import pytest
import torch

from benchmark import harness
from cafempc_tpu_torch import utils
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.solver.plan import StepData
from cafempc_tpu_torch.utils import tracing
from test_benchmark_program_metrics import Buffer

# reader -> the span it sums
SPANS = {"cascade.srb.lin_host_ms": "srb.partials",
         "cascade.srb.step_host_ms": "srb.step"}


def load(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "t_srb_" + name.replace(".", "_"))


@pytest.fixture(params=sorted(SPANS))
def reader(request):
    yield request.param, load(request.param)
    tracing.disable()
    tracing.reset()


def solves(buf, srb=True):
    """2 warm-up and 3 window solves; window solve i has two SRB
    linearizations of 2 + i host ms and four SRB steps of 0.5 + i host
    ms, beside an LQ stage and the WB spans (or, srb=False, a program
    without the SRB spans)."""
    def solve(i):
        kids = [("hsddp.lq", 40.0, 50.0), ("wb.partials", None, 20.0),
                ("wb.step", None, 9.0)]
        if srb:
            kids += [("srb.partials", None, 2.0 + i)] * 2
            kids += [("srb.step", None, 0.5 + i)] * 4
        buf.unit("hsddp.solve", kids, syncs=5)
    for i in (100, 200):
        solve(i)
    for i in range(3):
        solve(i)
    return dict(n_solves=3, profile=dict(n_units=1))


# the window's mean of the sums: 2 x (2 + i) and 4 x (0.5 + i) over
# i = 0, 1, 2
MEAN = {"cascade.srb.lin_host_ms": 6.0, "cascade.srb.step_host_ms": 6.0}
# the last solve alone (i = 2)
LAST = {"cascade.srb.lin_host_ms": 8.0, "cascade.srb.step_host_ms": 10.0}


def test_the_window_mean_of_the_sums(reader, monkeypatch):
    name, r = reader
    buf = Buffer()
    rec = solves(buf)
    buf.install(monkeypatch)
    assert r.read(rec) == pytest.approx(MEAN[name])
    assert r.WRAPPERS == ("profile",)


def test_one_solve_window(reader, monkeypatch):
    name, r = reader
    buf = Buffer()
    solves(buf)
    buf.install(monkeypatch)
    assert r.read(dict(n_solves=1, profile=dict(n_units=1))) \
        == pytest.approx(LAST[name])


def test_nothing_to_read_reads_none(reader, monkeypatch):
    """An empty buffer, a record without its window, a window longer
    than the solves recorded, a program without the SRB spans, and a
    program without the tracer: None."""
    name, r = reader
    rec = dict(n_solves=3, profile=dict(n_units=1))
    Buffer().install(monkeypatch)
    for x in (rec, {}):
        assert r.read(x) is None
    buf = Buffer()
    solves(buf)
    buf.install(monkeypatch)
    assert r.read(dict(n_solves=9, profile=dict(n_units=1))) is None
    buf = Buffer()
    solves(buf, srb=False)
    buf.install(monkeypatch)
    assert r.read(rec) is None
    with monkeypatch.context() as m:
        m.delattr(utils, "tracing")
        m.setitem(sys.modules, "cafempc_tpu_torch.utils.tracing", None)
        assert load(name).read(rec) is None


def test_a_recorded_trace(reader):
    """The program's own buffer: two `hsddp.solve` roots, each stepping
    and linearizing the SRB segment's functions on 3 scenarios x 5
    steps; the reader gives the mean over the two of each root's span
    host ms, summed; every span lies under a root, and the counters add
    15 knots a call."""
    name, r = reader
    f = mp.make_mhpc_fns(mp.MHPCConfig(), None, "srb")
    g = torch.Generator().manual_seed(7)
    X = 0.05 * torch.randn(3, 5, mp.XS, generator=g, dtype=torch.float64)
    X[..., 2] += 0.25
    U = torch.randn(3, 5, mp.US, generator=g, dtype=torch.float64)
    n = 5

    def full(*shape, v=0.0):
        return torch.full((n,) + shape, v, dtype=torch.float64)
    sd = StepData(**{k: full() for k in StepData._fields})._replace(
        dt=full(v=0.02), pf_ref=torch.rand(n, 12, generator=g,
                                           dtype=torch.float64),
        ref_contact=full(4, v=1.0))
    tracing.reset()
    tracing.enable()
    for _ in range(2):
        with tracing.span("hsddp.solve"):
            f.dyn(X, U, sd)
            f.dyn_partials(X, U, sd)
    tracing.disable()
    spans = tracing.spans()
    roots = [s for s in spans if s.parent is None]
    mine = [s for s in spans if s.name == SPANS[name]]
    assert [s.name for s in roots] == ["hsddp.solve"] * 2
    assert len(mine) == 2 and {s.root for s in mine} == {x.id for x in roots}
    want = sum(s.host_ms for s in mine) / 2
    assert r.read(dict(n_solves=2, profile=dict(n_units=1))) \
        == pytest.approx(want)
    assert {x.id: tracing.counts()[x.id] for x in roots} == {
        x.id: {"srb.step_knots": 15, "srb.lin_knots": 15} for x in roots}

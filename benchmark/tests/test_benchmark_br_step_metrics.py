"""The reader of the barrel-roll cell's whole-body forward step
(`br.wb.step_host_ms`), as `test_benchmark_br_lin_metrics.py` reads the
linearization: on synthetic tracer buffers, the window's solves only, the
sum of the `wb.step` host ms a solve and their mean, and None where
nothing was traced (a program whose barrel roll steps with the AD forward
dynamics, or one without the tracer); and on a buffer the program itself
recorded, the sum of its `wb.step` spans."""
import sys

import pytest
import torch

from benchmark import harness
from cafempc_tpu_torch import utils
from cafempc_tpu_torch.models import synthetic_robot, wb_lane
from cafempc_tpu_torch.utils import tracing
from test_benchmark_program_metrics import Buffer

NAME = "br.wb.step_host_ms"


def load():
    return harness.load_module(harness.HERE / "metrics" / f"{NAME}.py",
                               "t_br_step_" + NAME.replace(".", "_"))


@pytest.fixture
def reader():
    yield load()
    tracing.disable()
    tracing.reset()


def solves(buf, lane=True):
    """2 warm-up and 3 window solves; window solve i has three forward
    trials, each a dynamics step of 4 + i host ms and a reset of 1 host
    ms, beside an LQ stage with the WB partials (or, lane=False, the AD
    forward step, which records no span of its own)."""
    def solve(i):
        kids = [("hsddp.lq", 40.0, 50.0), ("wb.partials", None, 20.0),
                ("hsddp.line_search", None, 30.0)]
        if lane:
            for _ in range(3):
                kids += [("wb.step", None, 4.0 + i), ("wb.step", None, 1.0)]
        buf.unit("hsddp.solve", kids, syncs=5)
    for i in (100, 200):
        solve(i)
    for i in range(3):
        solve(i)
    return dict(n_solves=3, profile=dict(n_units=1))


def test_the_window_mean_of_the_sums(reader, monkeypatch):
    """Each window solve sums to 3 x (4 + i) + 3 x 1 ms; the mean over
    i = 0, 1, 2 is 18 ms, the warm-up solves and the other spans left
    out."""
    buf = Buffer()
    rec = solves(buf)
    buf.install(monkeypatch)
    assert reader.read(rec) == pytest.approx(18.0)
    assert reader.WRAPPERS == ("profile",)


def test_one_solve_window(reader, monkeypatch):
    """A window of the last solve alone: its own sum."""
    buf = Buffer()
    solves(buf)
    buf.install(monkeypatch)
    assert reader.read(dict(n_solves=1, profile=dict(n_units=1))) \
        == pytest.approx(3 * 6.0 + 3 * 1.0)


def test_nothing_to_read_reads_none(reader, monkeypatch):
    """An empty buffer, a record without its window, a window longer
    than the solves recorded, a program whose barrel roll steps with the
    AD forward dynamics, and a program without the tracer: None."""
    rec = dict(n_solves=3, profile=dict(n_units=1))
    Buffer().install(monkeypatch)
    for r in (rec, {}):
        assert reader.read(r) is None
    buf = Buffer()
    solves(buf)
    buf.install(monkeypatch)
    assert reader.read(dict(n_solves=9, profile=dict(n_units=1))) is None
    buf = Buffer()
    solves(buf, lane=False)
    buf.install(monkeypatch)
    assert reader.read(rec) is None
    with monkeypatch.context() as m:
        m.delattr(utils, "tracing")
        m.setitem(sys.modules, "cafempc_tpu_torch.utils.tracing", None)
        assert load().read(rec) is None


def test_a_recorded_trace(reader, tmp_path):
    """The program's own buffer: two `hsddp.solve` roots, each stepping
    the lane dynamics and the lane impulse reset on a small knot batch;
    the reader gives the mean over the two of each root's `wb.step` host
    ms, summed, and every `wb.step` span lies under a root."""
    m = wb_lane.load_lane_model(
        synthetic_robot.write_synthetic_quadruped_urdf(str(tmp_path)), "cpu",
        torch.float64)
    g = torch.Generator().manual_seed(7)
    x = 0.05 * torch.randn(3, 36, generator=g, dtype=torch.float64)
    x[:, 2] += 0.25
    x[:, 6:18] += torch.tensor([0.0, -0.8, 1.6] * 4, dtype=torch.float64)
    u = torch.randn(3, 12, generator=g, dtype=torch.float64)
    dt = torch.full((3,), 0.01, dtype=torch.float64)
    c = torch.tensor([[1.0, 1, 1, 1], [0, 1, 0, 1], [0, 0, 0, 0]],
                     dtype=torch.float64)
    tracing.reset()
    tracing.enable()
    for _ in range(2):
        with tracing.span("hsddp.solve"):
            wb_lane.wb_dynamics_lane(m, x, u, dt, c, 10.0)
            wb_lane.impulse_dynamics_lane(m, x[:, :18], x[:, 18:], 1.0 - c)
    tracing.disable()
    spans = tracing.spans()
    roots = [s for s in spans if s.parent is None]
    steps = [s for s in spans if s.name == "wb.step"]
    assert [s.name for s in roots] == ["hsddp.solve"] * 2
    assert len(steps) == 4 and {s.root for s in steps} == {r.id for r in roots}
    want = sum(s.host_ms for s in steps) / 2
    assert reader.read(dict(n_solves=2, profile=dict(n_units=1))) \
        == pytest.approx(want)
    assert {r.id: tracing.counts()[r.id]["wb.step_knots"]
            for r in roots} == {r.id: 6 for r in roots}

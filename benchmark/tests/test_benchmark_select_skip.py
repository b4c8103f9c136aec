"""The reader of `hsddp.select_skip_pct` on synthetic tracer buffers: the
share of select leaves passed through, per window solve from the
program's `hsddp.select_skip` and `hsddp.select_copy` counters, mean over
the window (the warm-up left out); None where the counters are missing,
as on a program that predates them, or nothing was traced."""
import sys

import pytest

from benchmark import harness
from cafempc_tpu_torch import utils
from cafempc_tpu_torch.utils import tracing
from cafempc_tpu_torch.utils.tracing import SpanRecord

NAME = "hsddp.select_skip_pct"
REC = dict(n_solves=3, profile=dict(n_units=1))


def load():
    return harness.load_module(harness.HERE / "metrics" / f"{NAME}.py",
                               "t_select_skip")


@pytest.fixture
def reader():
    yield load()
    tracing.disable()
    tracing.reset()


def install(monkeypatch, counts, n_roots=None):
    """Roots 1.. of `hsddp.solve`, one per entry of `counts` (or
    `n_roots`), with those counters."""
    n = len(counts) if n_roots is None else n_roots
    spans = [SpanRecord("hsddp.solve", i, None, i, 10 * i, 10 * i + 5, None)
             for i in range(1, n + 1)]
    per = {i + 1: c for i, c in enumerate(counts) if c is not None}
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "counts", lambda: dict(per))


def counters(skip, copy):
    return {"hsddp.sync": 17, "hsddp.select_skip": skip,
            "hsddp.select_copy": copy}


def test_mean_share_over_the_window(reader, monkeypatch):
    # two warm-up solves, then the window's three
    install(monkeypatch, [counters(0, 9), counters(1, 1), counters(3, 1),
                          counters(1, 0), counters(0, 4)])
    assert reader.read(REC) == pytest.approx((75.0 + 100.0 + 0.0) / 3)
    assert reader.WRAPPERS == ("profile",)


@pytest.mark.parametrize("counts", [
    [counters(3, 1)] * 2 + [{"hsddp.sync": 17}],          # a parent program
    [counters(3, 1)] * 2 + [counters(0, 0)],              # no select ran
    [counters(3, 1), None, counters(3, 1)],               # nothing counted
    [counters(3, 1)] * 2,                                 # too few solves
    [],                                                   # nothing traced
])
def test_nothing_to_read_reads_none(reader, monkeypatch, counts):
    install(monkeypatch, counts)
    assert reader.read(REC) is None
    assert reader.read({}) is None


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    install(monkeypatch, [counters(3, 1)] * 3)
    assert load().read(REC) == pytest.approx(75.0)
    with monkeypatch.context() as m:
        m.delattr(utils, "tracing")
        m.setitem(sys.modules, "cafempc_tpu_torch.utils.tracing", None)
        assert load().read(REC) is None

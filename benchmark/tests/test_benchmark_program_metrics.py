"""The readers of the program's own spans and counters
(`cafempc_tpu_torch/utils/tracing.py`) on synthetic tracer buffers: a
batched cell's warm-up and window solves, and a replan cell's
initializes, warm-up and window updates (the profiled units after the
window run with the tracer off).  Each reader picks the window's units,
each twin reads its base, and every reader returns None where nothing was
traced or the program has no tracer; the tracer is on from a traced
run's `Trace` to its profile, and loading a reader alone traces
nothing."""
import statistics
import sys

import pytest

from benchmark import harness
from cafempc_tpu_torch import utils
from cafempc_tpu_torch.utils import tracing
from cafempc_tpu_torch.utils.tracing import SpanRecord

NEW = ("hsddp.host_syncs", "cascade.hsddp.host_syncs",
       "hsddp.host_syncs.replan", "hsddp.select_ms", "hsddp.lq_ms",
       "cascade.hsddp.lq_ms", "cascade.wb.lin_host_ms", "runtime.tape_ms")
TWINS = {"cascade.hsddp.host_syncs": "hsddp.host_syncs",
         "hsddp.host_syncs.replan": "hsddp.host_syncs",
         "cascade.hsddp.lq_ms": "hsddp.lq_ms"}
# the readers of the replan cell; the others read batched cells
REPLAN = ("hsddp.host_syncs.replan", "runtime.tape_ms")


def load(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "t_program_" + name.replace(".", "_"))


@pytest.fixture
def readers():
    """Every new reader, loaded fresh; the tracer off and empty
    afterwards."""
    yield {n: load(n) for n in NEW}
    tracing.disable()
    tracing.reset()


class Buffer:
    """A synthetic tracer buffer: roots with their children, counts."""

    def __init__(self):
        self.spans, self.counts, self.next = [], {}, 1

    def unit(self, name, children=(), syncs=0):
        """A root `name` with children [(name, device_ms, host_ms)]."""
        rid, t = self.next, 1000 * self.next
        self.next += 1
        root = SpanRecord(name, rid, None, rid, t, t + 999, None)
        self.spans.append(root)
        for i, (child, dev_ms, host_ms) in enumerate(children):
            s = t + i
            self.spans.append(SpanRecord(
                child, self.next, rid, rid, s, s + int(host_ms * 1e6),
                dev_ms))
            self.next += 1
        if syncs:
            self.counts[rid] = {"hsddp.sync": syncs}
        return rid

    def install(self, monkeypatch):
        monkeypatch.setattr(tracing, "spans", lambda: list(self.spans))
        monkeypatch.setattr(tracing, "counts", lambda: dict(self.counts))


def batched(buf):
    """2 warm-up and 3 window solves; window solve i has selects of 1 + i
    and 0.5 ms, an LQ of 2 i ms, WB partials of 3 + i and 1 host ms,
    10 + i syncs.  Returns (rec, the expected values)."""
    def solve(i):
        buf.unit("hsddp.solve", [
            ("hsddp.select", 1.0 + i, 0.01), ("hsddp.select", 0.5, 0.01),
            ("hsddp.lq", 2.0 * i, 0.2), ("wb.partials", None, 3.0 + i),
            ("wb.impulse_partials", None, 1.0), ("hsddp.sync", None, 0.1)],
            syncs=10 + i)
    for i in (100, 200):
        solve(i)
    for i in range(3):
        solve(i)
    want = {"hsddp.host_syncs": 11.0, "hsddp.select_ms": 2.5,
            "hsddp.lq_ms": 2.0, "cascade.wb.lin_host_ms": 5.0}
    return dict(n_solves=3, profile=dict(n_units=1)), want


def replan(buf):
    """An initialize, 2 warm-up updates, 3 window updates with a second
    initialize among them (a new segment); window update i has a tape of
    (4, 1, 7)[i] ms and (5, 9, 6)[i] syncs."""
    def update(tape, syncs):
        buf.unit("runtime.update", [
            ("runtime.plan", None, 1.0), ("runtime.tape", None, tape),
            ("hsddp.solve", None, 50.0)], syncs=syncs)
    buf.unit("runtime.initialize", [("runtime.tape", None, 99.0)], syncs=99)
    update(100.0, 100)
    update(100.0, 100)
    update(4.0, 5)
    buf.unit("runtime.initialize", [("runtime.tape", None, 99.0)], syncs=99)
    update(1.0, 9)
    update(7.0, 6)
    want = {"hsddp.host_syncs.replan": 6.0, "runtime.tape_ms": 4.0}
    return dict(n_updates=3, profile=dict(n_units=2)), want


def test_the_window_is_picked(readers, monkeypatch):
    """Each reader reads its window's units only (the warm-up and the
    initializes left out), mean or median."""
    buf = Buffer()
    rec_b, want_b = batched(buf)
    rec_r, want_r = replan(buf)
    buf.install(monkeypatch)
    want = {**want_b, **want_r}
    for name, base in TWINS.items():
        want.setdefault(name, want.get(base))
    for name in NEW:
        got = readers[name].read(rec_r if name in REPLAN else rec_b)
        assert got == pytest.approx(want[name]), name
    # the replan cell's mean would differ: the median is what is read
    assert statistics.mean([5, 9, 6]) != want_r["hsddp.host_syncs.replan"]


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twins_read_their_base(readers, monkeypatch, twin):
    buf = Buffer()
    rec_b, _ = batched(buf)
    rec_r, _ = replan(buf)
    buf.install(monkeypatch)
    for rec in (rec_b, rec_r):
        assert readers[twin].read(rec) == readers[TWINS[twin]].read(rec)
    assert readers[twin].WRAPPERS == readers[TWINS[twin]].WRAPPERS \
        == ("profile",)


class FakeTrace:
    """`benchmark.tracing.Trace`'s two hooked methods, without a card."""

    def __init__(self):
        self.profile_out = None

    def profile(self, run_unit, n_units):
        for _ in range(n_units):
            run_unit()
        self.profile_out = dict(n_units=n_units)
        return self.profile_out


def test_the_tracer_is_on_from_a_traced_runs_trace_to_its_profile(
        readers):
    """Loading traces nothing; a run's `Trace` empties the buffer and
    turns the tracer on; its profile runs its units with the tracer off
    and leaves it off; hooking a class twice wraps it once.  The
    benchmark's own `Trace` is hooked by the loading."""
    from benchmark.tracing import Trace
    assert Trace.program_tracer_hooked
    base = readers["hsddp.host_syncs"]
    assert not tracing._TRACER.on
    cls = type("Run", (FakeTrace,), {})
    base.hook(cls)
    init, profile = cls.__init__, cls.profile
    base.hook(cls)
    assert (cls.__init__, cls.profile) == (init, profile)

    def unit():
        with tracing.span("hsddp.solve"):
            pass
    tracing.enable()
    unit()                              # a leftover of an earlier run
    run = cls()
    assert tracing._TRACER.on and tracing.spans() == []
    unit()
    assert run.profile(unit, 3) == dict(n_units=3)
    assert not tracing._TRACER.on
    assert [s.name for s in tracing.spans()] == ["hsddp.solve"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_traced_reads_none(readers, monkeypatch, name):
    """An empty buffer, a record without its window, spans without the
    field read, and a program without the tracer: None."""
    rec_b = dict(n_solves=3, profile=dict(n_units=1))
    rec_r = dict(n_updates=3, profile=dict(n_units=2))
    Buffer().install(monkeypatch)
    for rec in (rec_b, rec_r, {}):
        assert readers[name].read(rec) is None
    buf = Buffer()
    for _ in range(5):          # CPU spans: no device ms, too few roots
        buf.unit("hsddp.solve", [("hsddp.lq", None, 1.0)])
    buf.install(monkeypatch)
    if name.endswith("lq_ms"):
        assert readers[name].read(rec_b) is None
    assert readers[name].read(dict(n_solves=6, profile=dict(n_units=1))) \
        is None
    with monkeypatch.context() as m:
        m.delattr(utils, "tracing")
        m.setitem(sys.modules, "cafempc_tpu_torch.utils.tracing", None)
        assert load(name).read(rec_b) is None

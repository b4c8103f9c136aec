"""Spans and counters of the port's own stages, off by default.

    from cafempc_tpu_torch.utils import tracing
    tracing.enable()
    ...                        # solves, runtime updates
    spans = tracing.spans()    # [SpanRecord], in the order they opened
    counts = tracing.counts()  # {root id: {counter name: count}}
    tracing.disable()
    tracing.reset()            # drop what was recorded

A span (``with tracing.span("hsddp.lq", device=x):``) records its name,
its host start and end (`time.perf_counter_ns()`), its own id, its
parent's id and the id of its root: the outermost span open when it began,
which is the solve or the runtime update it belongs to.  `device`, a
tensor on the device of the span's work: where that is a CUDA device, the
span also records a CUDA event pair on the device's current stream, and
the pair is resolved to stream milliseconds only when the spans are read,
with one sync there.  No span syncs the host on the hot path.

While a `torch.profiler` run records, every span is also a
`record_function` range of its name, so a profile with CPU activity shows
the program's spans and the kernels they launched on one timeline
(`export_chrome_trace` writes it).

Counters (``tracing.count("hsddp.sync")``, or ``count(name, n)`` to add
n) are kept per root; a count made outside any span is kept under the
root id None.  The solver's `hsddp.sync` sits beside a `hsddp.sync` span
at each site: the count is what a reader sums, the span where the sync
lies on a timeline.  Its `hsddp.select_skip` and `hsddp.select_copy`
count the leaves of each select passed through and copied.

Off, `span()` returns one shared no-op object and `count()` returns at
once: nothing is allocated, no clock is read, no sync is made.
`stage(name)` is the runtimes' span: it reads the host clock whether or
not tracing is on (their `timing` dict is computed from it) and is
recorded only when it is.

Spans nest per thread.  Everything stays in memory until `reset()`;
nothing is written to disk.  A span keeps the device, never the tensor
it was given.  A long-running process that traces calls `spans()` and
`reset()` now and then: until read, each device span holds its event pair.
"""
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch


class SpanRecord(NamedTuple):
    """A span as read: `end_ns` is None while it is open, `device_ms`
    None for a span without device events (or still open)."""
    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: Optional[int]
    device_ms: Optional[float]

    @property
    def host_ms(self):
        return None if self.end_ns is None \
            else (self.end_ns - self.start_ns) / 1e6


class _NoSpan:
    """The span of a tracer that is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def _profiling():
    return torch._C._autograd._profiler_enabled()


class Span:
    """One span of a tracer; recorded in its buffer only when the tracer
    was on at its creation (`stage` spans always read the clock)."""
    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "root",
                 "device_ms", "_tracer", "_device", "_events", "_range")

    def __init__(self, tracer, name, device=None):
        self.name = name
        self.start_ns = self.end_ns = self.id = self.parent = None
        self.root = self.device_ms = self._events = self._range = None
        self._tracer = tracer
        self._device = device       # a CUDA torch.device, or None

    @property
    def ms(self):
        """Host milliseconds from enter to exit."""
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self):
        t = self._tracer
        if t is not None:
            stack = t._stack()
            top = stack[-1] if stack else None
            self.id = next(t._ids)
            self.parent = top.id if top is not None else None
            self.root = top.root if top is not None else self.id
            stack.append(self)
            t._spans.append(self)
            if _profiling():
                self._range = torch.autograd.profiler.record_function(
                    self.name)
                self._range.__enter__()
            if self._device is not None:
                stream = torch.cuda.current_stream(self._device)
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True), stream)
                self._events[0].record(stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        t = self._tracer
        if t is not None:
            if self._events is not None:
                self._events[1].record(self._events[2])
                self._events = self._events[:2]
            if self._range is not None:
                self._range.__exit__(*exc)
                self._range = None
            t._stack().pop()
        return False


class Tracer:
    """The buffer and switch of the spans and counters."""

    def __init__(self):
        self.on = False
        self._spans = []
        self._counts = {}
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def enable(self):
        self.on = True

    def disable(self):
        self.on = False

    def reset(self):
        """Drop every recorded span and count (open spans stay open)."""
        self._spans = []
        self._counts = {}

    def span(self, name, device=None):
        if not self.on:
            return NO_SPAN
        return Span(self, name, device.device
                    if device is not None and device.is_cuda else None)

    def stage(self, name):
        return Span(self if self.on else None, name)

    def count(self, name, n=1):
        if not self.on:
            return
        stack = self._stack()
        root = stack[-1].root if stack else None
        per = self._counts.setdefault(root, {})
        per[name] = per.get(name, 0) + n

    def spans(self):
        """Every recorded span in the order they opened; the device event
        pairs of closed spans resolved first (one sync a device)."""
        todo = [s for s in self._spans if s._events is not None
                and s.end_ns is not None and s.device_ms is None]
        for dev in {s._device for s in todo}:
            torch.cuda.synchronize(dev)
        for s in todo:
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = s._device = None
        return [SpanRecord(s.name, s.id, s.parent, s.root, s.start_ns,
                           s.end_ns, s.device_ms) for s in self._spans]

    def counts(self):
        return {root: dict(per) for root, per in self._counts.items()}


_TRACER = Tracer()
enable = _TRACER.enable
disable = _TRACER.disable
reset = _TRACER.reset
span = _TRACER.span
stage = _TRACER.stage
count = _TRACER.count
spans = _TRACER.spans
counts = _TRACER.counts

"""`hsddp.host_syncs`: host syncs a window unit, read from the program's
own `hsddp.sync` counter (`cafempc_tpu_torch/utils/tracing.py`: each loop
test's fetch and each segment's reset-site fetch, kept per root span):
mean over a batched cell's window solves, median over a replan cell's
window updates (`hsddp.host_syncs.replan`).

The other readers of the program's spans load this module for what they
share.  Loading it hooks the program's tracer to the traced run's
`benchmark.tracing.Trace`: the run's `Trace` being made (after the
readers are loaded, before the traffic starts) empties the tracer's
buffer and turns it on; `Trace.profile` turns it off before the profiled
units and leaves it off, so those units, and every metric read from the
profile, run as on a program without the tracer.  The buffer then holds
the warm-up and the window, the window last.  Untraced runs load no
reader, and loading alone traces nothing.  A program without the tracer
gets no hook and leaves nothing to read.
"""
import functools
import statistics

try:
    from cafempc_tpu_torch.utils import tracing
except ImportError:
    tracing = None

WRAPPERS = ("profile",)


def hook(trace_cls):
    """Tie the program's tracer to `trace_cls`'s runs (once a class)."""
    if tracing is None or getattr(trace_cls, "program_tracer_hooked", False):
        return
    init, profile = trace_cls.__init__, trace_cls.profile

    @functools.wraps(init)
    def traced_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        tracing.reset()
        tracing.enable()

    @functools.wraps(profile)
    def untraced_profile(self, *args, **kwargs):
        tracing.disable()
        return profile(self, *args, **kwargs)

    trace_cls.__init__, trace_cls.profile = traced_init, untraced_profile
    trace_cls.program_tracer_hooked = True


if tracing is not None:
    from benchmark.tracing import Trace
    hook(Trace)


def buffer():
    """(spans, counts) the program recorded, or None."""
    if tracing is None:
        return None
    spans = tracing.spans()
    return (spans, tracing.counts()) if spans else None


def window(rec, spans):
    """Root span ids of the window's units, in order: a batched cell's
    last `rec["n_solves"]` `hsddp.solve` roots, a replan cell's last
    `rec["n_updates"]` `runtime.update` roots (its untimed
    `runtime.initialize` roots skipped by name); the warm-up before them
    left out; None where there are fewer."""
    if "n_updates" in rec:
        name, n = "runtime.update", rec["n_updates"]
    elif "n_solves" in rec:
        name, n = "hsddp.solve", rec["n_solves"]
    else:
        return None
    roots = [s.id for s in spans if s.parent is None and s.name == name]
    return roots[-n:] if n and len(roots) >= n else None


def per_unit(rec, values):
    """A batched cell's mean over its window's units, a replan cell's
    median."""
    if "n_updates" in rec:
        return statistics.median(values)
    return sum(values) / len(values)


def span_sums(rec, names, field):
    """`per_unit` of each window unit's sum of `field` ("device_ms" or
    "host_ms") over its spans named in `names`; None where no such span
    was recorded or one lacks the field."""
    buf = buffer()
    units = None if buf is None else window(rec, buf[0])
    if units is None:
        return None
    sums = dict.fromkeys(units, 0.0)
    seen = False
    for s in buf[0]:
        if s.root in sums and s.name in names:
            v = getattr(s, field)
            if v is None:
                return None
            sums[s.root] += v
            seen = True
    return per_unit(rec, list(sums.values())) if seen else None


def read(rec):
    buf = buffer()
    units = None if buf is None else window(rec, buf[0])
    if units is None:
        return None
    counts = buf[1]
    return per_unit(rec, [counts.get(u, {}).get("hsddp.sync", 0)
                          for u in units])

"""The instruments of a `--trace 1` run, installed only there.

* `Trace.lq_wrap(fn)`: CUDA events around each call of an LQ-stage
  callable during the measured window (no sync); `stage.lq_ms` sums the
  spans' elapsed times per solve after the window.
* `Trace.mark_wrap(name, fn, work)`: during the profiled units only, a
  marker kernel (`torch.cuda._sleep`, which the port never launches) just
  before and just after each call; the profile opens with one marker
  alone, which names the marker's kernel.  In the device-only profile the ops
  between a pair of markers are the work launched inside that call, read
  by position on the stream and never by a kernel's name, so the kernel
  roofline reads the same work whatever implements it.
* `Trace.profile(units)`: a fixed number of solves or updates under
  `torch.profiler` (device activity only: a whole `mhpc` solve is ~69,000
  launches, and host events would take minutes to read back).  It gives
  the device's busy time as the union of the device ops' intervals (right
  for any number of streams), the wall of the profiled units, the kernel
  launches, the marked calls' device times and the breakdown.
"""
import time

import torch

COPIES = ("Memcpy", "Memset")
N_BREAKDOWN = 10


class Trace:
    def __init__(self):
        self.lq_spans = []        # (start, end) events of the window's calls
        self.lq_on = False
        self.marking = False
        self.marked = []          # (name, work) of each marked call, in order
        self.profile_out = None

    # ---------------- wrappers ---------------------------------------
    def lq_wrap(self, fn):
        def call(*args, **kwargs):
            if not self.lq_on:
                return fn(*args, **kwargs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            self.lq_spans.append((e0, e1))
            return out
        return call

    def mark_wrap(self, name, fn, work):
        """fn with markers around it while profiling; work(args, kwargs,
        out) -> (bytes, ops or a thunk giving them, dtype) of the call."""
        def call(*args, **kwargs):
            if not self.marking:
                return fn(*args, **kwargs)
            torch.cuda._sleep(1)
            out = fn(*args, **kwargs)
            torch.cuda._sleep(1)
            self.marked.append((name, work(args, kwargs, out)))
            return out
        return call

    def lq_ms(self):
        """Elapsed ms of each recorded LQ-stage call (syncs first)."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.lq_spans]

    # ---------------- the profiled units -----------------------------
    def profile(self, run_unit, n_units):
        """run_unit() n_units times under torch.profiler, each ending in a
        host fetch; stores and returns the reduction (`reduce`)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.marked = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            self.marking = True
            t0 = time.perf_counter()
            for _ in range(n_units):
                run_unit()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            self.marking = False
        dev = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        self.profile_out = reduce(dev, wall, n_units, self.marked)
        return self.profile_out


def union_s(spans):
    """Seconds covered by the union of (start_us, end_us) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def reduce(dev, wall_s, n_units, marked):
    """Device ops [(name, start_us, end_us)] of the profile, the lone
    marker first, then the profiled units' -> a
    dict: busy_s and window_s, kernel launches per unit, the marked calls'
    (name, work, device ms) and the breakdown; None where the profiler saw
    no device activity."""
    if len(dev) < 2:
        return None
    dev = sorted(dev, key=lambda t: t[1])
    # the first op is the lone marker launched before the units
    marker, dev = dev[0][0], dev[1:]
    ops = [d for d in dev if d[0] != marker]
    launches = sum(1 for d in ops if not d[0].startswith(COPIES))
    # marked calls: the ops between the 2i-th and (2i+1)-th marker
    calls, inside, opened = [], 0.0, False
    for name, s, e in dev:
        if name == marker:
            if opened:
                calls.append(inside / 1e3)
            inside, opened = 0.0, not opened
        elif opened:
            inside += e - s
    marks = []
    if len(calls) == len(marked) and not opened:
        marks = [(n, w, ms) for (n, w), ms in zip(marked, calls)]
    by_name = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:N_BREAKDOWN]
    gaps, last = [], None     # last: (name, end) of the op ending latest
    for name, s, e in ops:
        if last is not None and s > last[1]:
            gaps.append((f"after {last[0][:60]} | before {name[:60]}",
                         (s - last[1]) / 1e6))
        if last is None or e > last[1]:
            last = (name, e)
    gaps = sorted(gaps, key=lambda g: -g[1])[:N_BREAKDOWN]
    return dict(busy_s=union_s([(s, e) for _, s, e in ops]),
                window_s=wall_s, launches=launches / n_units,
                n_units=n_units, marks=marks, marks_seen=len(calls),
                marks_wanted=len(marked),
                breakdown=dict(device_ops=[[k, v] for k, v in top],
                               idle_gaps=[[k, v] for k, v in gaps]))

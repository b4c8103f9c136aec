"""Traffic `replan`: the MPC controller's closed loop at B=1.  After an
untimed `initialize` and `warmup` untimed updates, the window calls
`update(x_k)` back to back, each advancing one MPC period of the gait; the
controller waits for each.

x_k is the gait's state reference at update k's MPC time (k periods after
the initialize) + N(0, x_sigma^2) per entry, drawn from the seed in
update order.  Where the next update would run past the gait
(`gait_seconds`), a new runtime is made and initialized, untimed, and the
loop goes on from the gait's start.

Each update is timed on the host clock from the call of `update(x)` to
its command tape in host memory.  A failed update (no success or a
non-finite cost) counts in `failed` and as an infinite sample.
Workload parameters: `x_sigma`, `warmup`, `gait_seconds`,
`profile_units`, and under `check` the number of sampled `updates` and
the limits.
"""
import math
import statistics
import time

import numpy as np
import torch

from benchmark import check

# updates after the initialize (warm-up ones) that the reference solves
# from its own answers alone
CHAIN = 2


def percentile(samples, q):
    """Nearest-rank percentile (q in (0, 100]) of all samples."""
    s = sorted(samples)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def latency(samples):
    """replan_ms_p50 and replan_ms_p95 over all of the window's samples
    (a failed update is an infinite sample)."""
    return dict(replan_ms_p50=statistics.median(samples),
                replan_ms_p95=percentile(samples, 95))


def run(ctx):
    cfg, wl, dev, prob = ctx.cfg, ctx.params, ctx.device, ctx.problem
    gait = prob.make_gait(cfg, wl["gait_seconds"])
    models = prob.make_models()
    dt_mpc, window = prob.dt_mpc(cfg), prob.window_s(cfg)
    # updates one initialize can take before the reference window would
    # leave the gait (QuadReference.step)
    per = int(round(dt_mpc / gait.dt))
    n_seg = (len(gait) - int(round(window / gait.dt)) - 3) // per - 1
    x_ref = [prob.state_ref_at(gait, k * dt_mpc) for k in range(n_seg + 1)]
    rng = np.random.default_rng(int(ctx.seed) % (2 ** 63))
    xdim = len(x_ref[0])

    answers, states = {}, {}
    st = dict(seg=-1, k=0, rt=None)

    def x_of(k):
        return x_ref[k] + wl["x_sigma"] * rng.normal(size=xdim)

    def new_segment():
        st["seg"] += 1
        st["k"] = 0
        st["rt"] = None
        rt = prob.program_runtime(cfg, gait, dev, models)
        x = x_of(0)
        tape = rt.initialize(x)
        st["rt"] = rt
        key = (st["seg"], 0)
        states[key] = x
        answers[key] = prob.runtime_answer(rt, tape)

    def step():
        """One update (a new segment first where the gait ends); returns
        (seconds, answer ok)."""
        if st["k"] + 1 > n_seg:
            new_segment()
        x = x_of(st["k"] + 1)
        rt = st["rt"]
        t0 = time.perf_counter()
        tape = rt.update(x)
        dt = time.perf_counter() - t0
        st["k"] += 1
        key = (st["seg"], st["k"])
        states[key] = x
        a = answers[key] = prob.runtime_answer(rt, tape)
        return dt, a["success"] and math.isfinite(a["cost"]), key

    new_segment()
    for _ in range(wl["warmup"]):
        step()
    setup_s = time.perf_counter() - ctx.t_start

    samples, keys, timing = [], [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        dt, ok, key = step()
        samples.append(dt * 1e3 if ok else math.inf)
        keys.append(key)
        timing.append(dict(st["rt"].timing))
    n_fail = sum(1 for s in samples if not math.isfinite(s))
    e2e = latency(samples)
    out = dict(attempted=len(samples), failed=n_fail, setup_s=setup_s,
               e2e=e2e, record=dict(n_updates=len(samples), timing=timing))
    if ctx.trace is not None:
        out["record"]["profile"] = ctx.trace.profile(step,
                                                     wl["profile_units"])
    ck = ctx.check
    # the first initialize and the CHAIN updates after it, then a
    # sample of the window's updates with its last two always in it
    head = [(0, k) for k in range(min(CHAIN, wl["warmup"]) + 1)]
    picks = check.sample(ctx.seed, len(keys), ck["updates"],
                         must=(len(keys) - 2, len(keys) - 1))
    out["answers"] = dict(
        keys=head + [keys[i] for i in picks if keys[i] not in head],
        states=states, program=answers)
    out["gait"], out["models"] = gait, models
    st["rt"] = None
    return out


def reference(ctx, out, dtype):
    """The reference's answer of every sampled update.  The initialize is
    solved from scratch; an update warm-starts from the reference's own
    answer to the update before it where that is in the sample, and from
    the program's otherwise.  So the initialize and the CHAIN updates
    after it are the reference's alone, from the states only, and the
    window's last update follows the reference's answer to the one
    before it, which follows the program's."""
    a = out["answers"]
    ref = ctx.problem.ReferenceRuntime(ctx.cfg, out["gait"], ctx.device,
                                       dtype, out["models"])
    own = {}
    for seg, k in a["keys"]:
        prev = None
        if k:
            prev = own.get((seg, k - 1), a["program"][(seg, k - 1)])
        own[(seg, k)] = ref.answer(k, a["states"][(seg, k)], prev)
    return [own[key] for key in a["keys"]]


def numbers(out, ref, side=None):
    a = out["answers"]
    mine = side if side is not None else [a["program"][key]
                                          for key in a["keys"]]
    return check.replan_numbers(list(zip(mine, ref)))


def control(ctx, out):
    """The control: the reference in f32 (the next precision down from
    the config's f64), chained as the reference is."""
    return reference(ctx, out, torch.float32)

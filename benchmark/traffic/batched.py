"""Traffic `batched`: a closed loop of back-to-back batched HS-DDP solves,
each on a fresh batch of start states.

Workload parameters: `batch` (scenarios a solve), `x0_sigma` (the start
states are the problem's nominal start + N(0, x0_sigma^2) per entry),
`pool` (batches drawn on the card from the seed during set-up; solve i
takes batch i mod pool), `warmup` (untimed solves on batches of their
own), `gait_seconds`, `profile_units` (solves profiled after the window
in a `--trace 1` run), and under `check` the sample (`solves`,
`scenarios` a solve) and the limits.

The window runs from the first dispatch to the host fetch of the last
solve's cost and success; it ends with the first solve that finishes
after `--seconds`.  `solves_per_s` counts the scenarios solved with
success and a finite cost over the window's seconds.
"""
import copy
import time
import types

import numpy as np
import torch

from benchmark import check, roofline


def _seed64(seed):
    return int(seed) % (2 ** 63)


def solved(answers):
    """Scenarios solved with success and a finite cost, over all of the
    window's solves [(pool index, cost [B], success [B])]."""
    return sum(int((ok & np.isfinite(cost)).sum()) for _, cost, ok in answers)


def run(ctx):
    cfg, wl, dev, prob = ctx.cfg, ctx.params, ctx.device, ctx.problem
    B = wl["batch"]
    dtype = getattr(torch, cfg["batched"]["dtype"])
    gait = prob.make_gait(cfg, wl["gait_seconds"])
    models = prob.make_models()
    p = prob.program_batched(cfg, gait, dev, dtype, B, models)
    x_nom = torch.as_tensor(prob.nominal_x0(cfg, gait), dtype=torch.float64)
    n_pool, n_warm = wl["pool"], wl["warmup"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(_seed64(ctx.seed))
    pool = (x_nom.to(dev)[None, None] + wl["x0_sigma"] * torch.randn(
        (n_pool + n_warm, B, x_nom.shape[0]), generator=gen, device=dev,
        dtype=torch.float64)).to(dtype)
    fns, hooks = p["fns"], dict(p["hooks"])
    trace = ctx.trace
    if trace is not None:
        if "lq_events" in ctx.wrappers:
            fns, hooks = prob.lq_stage(fns, hooks, trace.lq_wrap)
        if "mark.hkd_lq" in ctx.wrappers:
            hooks = prob.mark_fused_lq(hooks, trace, roofline.PEAKS[dtype])
    solve = build_solver(ctx, fns, hooks, p, dtype)
    plan, pen, Xbar0, Ubar0 = p["plan"], p["pen"], p["Xbar0"], p["Ubar0"]

    def one(i):
        return solve(plan, pen, pool[i], Xbar0, Ubar0)

    for j in range(n_warm):
        one(n_pool + j).cost.cpu()
    setup_s = time.perf_counter() - ctx.t_start

    answers, ls = [], []
    if trace is not None:
        trace.lq_on = True
    t0 = time.perf_counter()
    i = 0
    while True:
        res = one(i % n_pool)
        cost, ok = res.cost.cpu(), res.success.cpu()
        answers.append((i % n_pool, cost.double().numpy(), ok.numpy()))
        if trace is not None:
            ls.append(res.info.ls_iters.sum())
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    n_ok = solved(answers)
    out = dict(attempted=len(answers) * B, failed=len(answers) * B - n_ok,
               setup_s=setup_s, e2e=dict(solves_per_s=n_ok / window_s),
               record=dict(n_solves=len(answers)))
    if trace is not None:
        trace.lq_on = False
        rec = out["record"]
        rec["lq_ms"] = trace.lq_ms()
        rec["ls_iters"] = [float(t) for t in ls]
        nxt = [len(answers)]

        def unit():
            one(nxt[0] % n_pool).cost.cpu()
            nxt[0] += 1
        rec["profile"] = trace.profile(unit, wl["profile_units"])
        rec["marks"] = finish_marks(trace)

    # what the check compares: the sampled solves' scenarios and the last
    # solve's trajectories, kept before the program's state is freed
    ck = ctx.check
    picks = check.sample(ctx.seed, len(answers), ck["solves"],
                         must=(len(answers) - 1,))
    rng = np.random.default_rng(_seed64(ctx.seed) + 1)
    x0s, cost_p, ok_p, last_rows, X_p, K_p = [], [], [], [], [], []
    for s in picks:
        idx, cost, ok = answers[s]
        scen = np.sort(rng.choice(B, size=min(ck["scenarios"], B),
                                  replace=False))
        for j in scen:
            if s == picks[-1]:
                last_rows.append(len(x0s))
                X_p.append(res.Xbar[int(j)].double().cpu().numpy())
                K_p.append(res.K[int(j)].double().cpu().numpy())
            x0s.append(pool[idx, int(j)].cpu())
            cost_p.append(float(cost[j]))
            ok_p.append(bool(ok[j]))
    X_all, K_all = [None] * len(x0s), [None] * len(x0s)
    for r, X, K in zip(last_rows, X_p, K_p):
        X_all[r], K_all[r] = X, K
    out["answers"] = dict(x0=torch.stack(x0s), cost=cost_p,
                          ok=ok_p, last_rows=last_rows, X=X_all, K=K_all)
    out["gait"], out["models"] = gait, models
    return out


def build_solver(ctx, fns, hooks, p, dtype):
    """make_batched_solver with the config's keywords; in a traced run
    whose metrics need it, with `ops.sweep.sweep` marked (by attribute,
    while the solver is built, as chip_smoke.capturing_solver does)."""
    from cafempc_tpu_torch.ops import sweep as sweep_mod
    from cafempc_tpu_torch.parallel.mesh import make_batched_solver
    trace = ctx.trace
    if trace is None or "mark.sweep" not in ctx.wrappers:
        return make_batched_solver(fns, p["opts"], **hooks, **p["solver_kw"])
    real = sweep_mod.sweep
    peak = roofline.PEAKS[dtype]

    def work(args, kwargs, out):
        # the operation count needs w on the host: read after the profile,
        # keeping only w (the operands would hold gigabytes)
        Bsz, N, xs = args[0].shape[:3]
        us, w = args[3].shape[-1], args[10]
        return roofline.nbytes(args, out), (
            lambda: roofline.sweep_flops_counts(Bsz, N, xs, us,
                                                int((w > 0).sum()))), peak
    sweep_mod.sweep = trace.mark_wrap("sweep", real, work)
    try:
        return make_batched_solver(fns, p["opts"], **hooks, **p["solver_kw"])
    finally:
        sweep_mod.sweep = real


def finish_marks(trace):
    """{name: [(bound ms, device ms)]} of the profiled units' marked
    calls (the deferred operation counts read now)."""
    prof = trace.profile_out
    out = {}
    if not prof:
        return out
    for name, (nb, ops, peak), dev_ms in prof["marks"]:
        ops = ops() if callable(ops) else ops
        out.setdefault(name, []).append(
            (roofline.bound(nb, ops, peak)[0], dev_ms))
    return out


def reference(ctx, out, dtype, tf32=False):
    """The plain reference's (cost, ok, X, K) on the sampled scenarios, on
    the run's device in `dtype` (`tf32`: matmuls in TF32, the control)."""
    a = out["answers"]
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        cost, ok, X, K = ctx.problem.reference_batched(
            ctx.cfg, out["gait"], ctx.device, dtype, a["x0"], out["models"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return dict(cost=[float(c) for c in cost], ok=[bool(o) for o in ok],
                X=list(X), K=list(K))


def numbers(out, ref, side=None):
    """The check's numbers of the program's answers (or of `side`, a
    reference-shaped answer set put in the program's place)."""
    a = out["answers"]
    side = a if side is None else side
    return check.batched_numbers(side["cost"], side["ok"], ref["cost"],
                                 ref["ok"], side["X"], ref["X"], side["K"],
                                 ref["K"], a["last_rows"])


def control(ctx, out):
    """The control: the reference in the next precision down from the
    config's (f32 with TF32 for f32 with TF32 off; f32 for f64)."""
    dtype = getattr(torch, ctx.cfg["batched"]["dtype"])
    if dtype == torch.float64:
        return reference(ctx, out, torch.float32)
    return reference(ctx, out, torch.float32, tf32=True)


def fault(ctx, out, ref):
    """A planted fault, put in the program's place: the last AL
    iteration's step not taken.  Costs and trajectories are the
    reference's (in the config's precision) after one AL iteration fewer;
    the gains are the f64 reference's own (`ref`), as a solve that drops
    its final line search and trial leaves them."""
    cfg = copy.deepcopy(ctx.cfg)
    b = cfg["batched"]
    b["opts"]["max_AL_iter"] = b["opts"]["max_AL_iter"] - 1
    short = reference(types.SimpleNamespace(**dict(vars(ctx), cfg=cfg)), out,
                      getattr(torch, b["dtype"]))
    return dict(short, K=ref["K"])

"""The `hkd` problem: HKD-MPC on the synthetic bound gait.

Inputs the benchmark makes itself and hands to both sides: the gait
(`reference/plain`'s synthetic bound generator), the nominal start state
(the bench pose, as `chip_smoke.bench_problem` builds it, copied) and the
states of the replans (the gait's HKD state reference at each MPC time).
The program side builds its plan, penalties and solver from those with
the port (`cafempc_tpu_torch`); the reference side does the same with the
frozen plain copy under `benchmark/reference/plain`.
"""
import dataclasses

import numpy as np
import torch

from benchmark.reference.plain.models import hkd as ref_hkd
from benchmark.reference.plain.reference import quad_reference as ref_qr
from benchmark.reference.plain.reference import synthetic as ref_syn

# the HKD LQ reads these penalty fields (problems/hkd_fused.py::_penalties)
LQ_PEN = ("reb_delta", "reb_eps", "reb_active", "al_lambda", "al_sigma",
          "al_active")


# ---------------- inputs the benchmark makes ------------------------------
def make_gait(cfg, duration):
    """The gait (host numpy QuadReferenceData of the plain copy)."""
    return ref_syn.synthetic_bound_reference(duration=duration,
                                             **cfg["gait"])


def _full_window(gait):
    qr = ref_qr.QuadReference(gait)
    qr.initialize((len(gait) - 3) * gait.dt)
    return qr


def nominal_x0(cfg, gait):
    """The bench pose (chip_smoke.bench_problem): body at z = 0.2486, legs
    at [0, -0.8, 1.6], qdummy from the first phase's contact."""
    settings = cfg["settings"]
    qr = ref_qr.QuadReference(gait)
    qr.initialize(settings["plan_duration"])
    hcfg = ref_hp().HKDConfig(**settings)
    phases = ref_hp().discover_phases(qr, hcfg.plan_duration, hcfg.dt_sim)
    body = np.zeros(12)
    body[5] = cfg["x0"]["z"]
    f64 = torch.float64
    qd = ref_hkd.compute_hkd_state(
        torch.tensor(body[0:3], dtype=f64), torch.tensor(body[3:6], dtype=f64),
        torch.tensor(list(cfg["x0"]["qJ_leg"]) * 4, dtype=f64),
        torch.tensor(phases[0][3], dtype=f64))
    return np.concatenate([body, qd.numpy()])


def state_ref_at(gait, t):
    """The gait's HKD state reference at absolute time t."""
    return ref_qr.hkd_state_ref_at(_full_window(gait), t)


def dt_mpc(cfg):
    s = cfg["settings"]
    return s["nsteps_between_mpc"] * s["dt_sim"]


def window_s(cfg):
    return cfg["settings"]["plan_duration"]


def make_models():
    """No robot model: the HKD model is closed-form."""
    return None


def ref_hp():
    from benchmark.reference.plain.problems import hkd_problem
    return hkd_problem


# ---------------- the program (the port) ----------------------------------
def port_gait(gait):
    from cafempc_tpu_torch.reference.quad_reference import QuadReferenceData
    return QuadReferenceData(**{f.name: getattr(gait, f.name)
                                for f in dataclasses.fields(gait)})


def program_batched(cfg, gait, device, dtype, batch, models=None):
    """The port's batched-solve inputs and functions: dict(plan, pen,
    Xbar0, Ubar0 (batched), fns, hooks, solver_kw, opts)."""
    from cafempc_tpu_torch import convert
    from cafempc_tpu_torch.parallel.mesh import broadcast_batch
    from cafempc_tpu_torch.problems import hkd_fused as hf
    from cafempc_tpu_torch.problems import hkd_problem as hp
    from cafempc_tpu_torch.reference.quad_reference import QuadReference
    from cafempc_tpu_torch.solver.options import SolverOptions
    b = cfg["batched"]
    qr = QuadReference(port_gait(gait))
    qr.initialize(cfg["settings"]["plan_duration"])
    plan_np, pen_np, Xbar0, Ubar0, _ = hp.build_hkd_plan(
        qr, hp.HKDConfig(**cfg["settings"]))
    plan, pen, Xbar0, Ubar0 = convert.from_numpy(
        (plan_np, pen_np, Xbar0, Ubar0), device, dtype)
    hooks = {}
    if "fused_forward" in b["hooks"]:
        hooks["fused_forward"] = hf.make_hkd_fused_forward()
    if "fused_lq" in b["hooks"]:
        hooks["fused_lq"] = hf.make_hkd_fused_lq()
    return dict(plan=plan, pen=broadcast_batch(pen, batch),
                Xbar0=broadcast_batch(Xbar0, batch),
                Ubar0=broadcast_batch(Ubar0, batch), fns=hp.make_hkd_fns(),
                hooks=hooks, opts=SolverOptions(**b["opts"]),
                solver_kw=dict(b["solver"]))


def lq_stage(fns, hooks, wrap):
    """(fns, hooks) with the LQ stage's callable wrapped: the fused LQ
    hook, which replaces every per-knot linearization."""
    return fns, dict(hooks, fused_lq=wrap(hooks["fused_lq"]))


def mark_fused_lq(hooks, trace, peak):
    """hooks with the fused LQ hook marked for its roofline: bytes of the
    trajectory and penalties it reads, the plan, and the fields it
    writes; no operation count (the bound is the bytes', as in
    chip_smoke's phase 2)."""
    from benchmark import roofline

    def work(args, kwargs, out):
        plan, pen, tr = args[:3]
        ins = [tr.X, tr.U] + [getattr(pen, n) for n in LQ_PEN] \
            + list(plan.step) + list(plan.knot)
        outs = [getattr(out, f) for f in out._fields
                if getattr(out, f) is not getattr(tr, f)]
        return roofline.nbytes(ins, outs), 0.0, peak
    return dict(hooks, fused_lq=trace.mark_wrap("hkd_lq", hooks["fused_lq"],
                                                work))


def program_runtime(cfg, gait, device, models=None):
    """The port's HKD-MPC runtime (f64 by the config) on the gait."""
    from cafempc_tpu_torch.problems import hkd_problem as hp
    from cafempc_tpu_torch.reference.quad_reference import QuadReference
    from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
    from cafempc_tpu_torch.solver.options import SolverOptions
    r = cfg["replan"]
    qr = QuadReference(port_gait(gait))
    qr.initialize(cfg["settings"]["plan_duration"])
    return HKDMPCRuntime(qr, hp.HKDConfig(**cfg["settings"]),
                         SolverOptions(**r["opts"]), device=device,
                         dtype=getattr(torch, r["dtype"]))


def runtime_answer(rt, tape):
    """What an update answers: cost, success and the command tape."""
    res = rt.result
    return dict(cost=float(res.cost), success=bool(res.success),
                Xbar=res.Xbar, Ubar=res.Ubar,
                tape=dict(controls=tape.controls,
                          des_body_state=tape.des_body_state,
                          feedback=tape.feedback))


# ---------------- the plain reference -------------------------------------
def reference_batched(cfg, gait, device, dtype, x0, models=None):
    """The reference's solve of the batched cell's plan from x0 [S, xs]:
    (cost [S], success [S], Xbar [S, N+1, xs], K [S, N, us, xs]) as host
    numpy."""
    from benchmark.reference.plain import convert
    from benchmark.reference.plain.solver.hsddp import make_solver
    from benchmark.reference.plain.solver.options import SolverOptions
    hp = ref_hp()
    b = cfg["batched"]
    qr = ref_qr.QuadReference(gait)
    qr.initialize(cfg["settings"]["plan_duration"])
    plan_np, pen_np, Xbar0, Ubar0, _ = hp.build_hkd_plan(
        qr, hp.HKDConfig(**cfg["settings"]))
    plan, pen, Xbar0, Ubar0 = convert.from_numpy(
        (plan_np, pen_np, Xbar0, Ubar0), device, dtype)
    S = x0.shape[0]

    def rep(t):
        return t.unsqueeze(0).expand((S,) + tuple(t.shape)).contiguous()
    solve = make_solver(hp.make_hkd_fns(), SolverOptions(**b["opts"]),
                        **b["solver"])
    res = solve(plan, type(pen)(*[rep(t) for t in pen]),
                x0.to(device, dtype), rep(Xbar0), rep(Ubar0))
    return (res.cost.double().cpu().numpy(), res.success.cpu().numpy(),
            res.Xbar.double().cpu().numpy(), res.K.double().cpu().numpy())


class ReferenceRuntime:
    """The reference's replans: `answer(k, x, prev)` solves update k (the
    initialize at k = 0, from scratch) from state x, warm-started from
    `prev`, an answer to update k-1 (the program's or the reference's
    own); the plan is rebuilt from the gait at MPC time k * dt_mpc, the
    warm start and the solve are the reference's own."""

    def __init__(self, cfg, gait, device, dtype, models=None):
        from benchmark.reference.plain.solver.hsddp import make_solver
        from benchmark.reference.plain.solver.options import SolverOptions
        self.hp = ref_hp()
        self.cfg, self.gait, self.device, self.dtype = cfg, gait, device, dtype
        self.hcfg = self.hp.HKDConfig(**cfg["settings"])
        opts = SolverOptions(**cfg["replan"]["opts"])
        kw = dict(fused_riccati=True, parallel_line_search=False,
                  max_resets=cfg["replan"]["max_resets"])
        self.solve_init = make_solver(self.hp.make_hkd_fns(), opts, **kw)
        self.solve_rt = make_solver(self.hp.make_hkd_fns(), opts.runtime(),
                                    **kw)
        self.dt_mpc = self.hcfg.nsteps_between_mpc * self.hcfg.dt_sim

    def _window(self, k):
        qr = ref_qr.QuadReference(self.gait)
        qr.initialize(self.hcfg.plan_duration)
        for _ in range(k):
            qr.step(self.dt_mpc)
        return qr

    def _mpc_time(self, k):
        t = 0.0
        for _ in range(k):
            t += self.dt_mpc
        return t

    def plan(self, k):
        return self.hp.build_hkd_plan(self._window(k), self.hcfg)

    def _solve(self, solve, plan_np, pen_np, x, Xb, Ub):
        from benchmark.reference.plain import convert
        from benchmark.reference.plain.solver.plan import host_plan_to_device
        plan = host_plan_to_device(plan_np, self.device, self.dtype)
        pen = host_plan_to_device(pen_np, self.device, self.dtype)
        pen = type(pen)(*[a[None] for a in pen])
        batch = [convert.from_numpy(np.asarray(a)[None], self.device,
                                    self.dtype) for a in (x, Xb, Ub)]
        res = convert.to_numpy(solve(plan, pen, *batch))
        return type(res)(*[a[0] if isinstance(a, np.ndarray) else
                           type(a)(*[v[0] for v in a]) for a in res])

    def answer(self, k, x, prev):
        from benchmark.reference.plain.runtime.warm_start import (
            time_aligned_warm_start)
        plan_np, pen_np, Xbar0, Ubar0, _ = self.plan(k)
        if k == 0:
            res = self._solve(self.solve_init, plan_np, pen_np, x, Xbar0,
                              Ubar0)
        else:
            old_plan = self.plan(k - 1)[0]
            t = self._mpc_time(k)
            # the runtime's own shift of the old plan: t - dt, not t(k-1)
            Xb, Ub = time_aligned_warm_start(
                old_plan.knot, t - self.dt_mpc, prev["Xbar"],
                prev["Ubar"], plan_np.knot, t, Xbar0, Ubar0)
            res = self._solve(self.solve_rt, plan_np, pen_np, x, Xb, Ub)
        return dict(cost=float(res.cost), success=bool(res.success),
                    Xbar=res.Xbar, Ubar=res.Ubar,
                    tape=hkd_tape(plan_np, self.hcfg, res))


def hkd_tape(plan_np, hcfg, res):
    """The command tape's controls, desired body states and feedback
    (runtime/mpc.py::command_tape, copied)."""
    n = hcfg.nsteps_between_mpc + 7
    active = np.asarray(plan_np.step.active)
    is_reset = np.asarray(plan_np.step.is_reset)
    idx = np.where((active > 0) & (is_reset == 0))[0][:n]
    return dict(controls=res.Ubar[idx], des_body_state=res.Xbar[idx][:, :12],
                feedback=res.K[idx][:, :12, :12])

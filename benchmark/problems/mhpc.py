"""The `mhpc` problem: the MHPC cascade (whole-body head, SRB tail) on the
synthetic quadruped and the synthetic bound gait in URDF leg order.

Inputs the benchmark makes itself and hands to both sides: the gait
(`reference/plain`'s generator), the URDF (written by the plain copy of
`models/synthetic_robot.py` into a temporary directory, read by both), the
nominal start state (the gait's WB state at t = 0, as
`chip_smoke.mhpc_problem` takes it, copied) and the replans' states.
"""
import dataclasses
import tempfile

import numpy as np
import torch

from benchmark.reference.plain.models import synthetic_robot as ref_robot
from benchmark.reference.plain.reference import quad_reference as ref_qr
from benchmark.reference.plain.reference import synthetic as ref_syn

# the runtime's command-tape rows that the check compares (MHPCRuntime)
TAPE_STEPS = 8


def ref_mp():
    from benchmark.reference.plain.problems import mhpc_problem
    return mhpc_problem


def _window_s(cfg):
    s = cfg["settings"]
    return s["plan_dur_wb"] + s["plan_dur_srb"]


# ---------------- inputs the benchmark makes ------------------------------
def make_gait(cfg, duration):
    return ref_syn.synthetic_bound_reference_urdf(duration=duration,
                                                  **cfg["gait"])


def write_urdf(tmp):
    return ref_robot.write_synthetic_quadruped_urdf(tmp)


def nominal_x0(cfg, gait):
    return state_ref_at(gait, 0.0)


def state_ref_at(gait, t):
    qr = ref_qr.QuadReference(gait)
    qr.initialize((len(gait) - 3) * gait.dt)
    return ref_qr.wb_state_ref_at(qr, t)


def dt_mpc(cfg):
    return cfg["settings"]["dt_mpc"]


def window_s(cfg):
    return _window_s(cfg)


def make_models():
    return Models()


class Models:
    """The URDF written once per process, and the models of each side
    loaded from it (by device and dtype)."""

    def __init__(self):
        self._tmp = tempfile.TemporaryDirectory()
        self.urdf = write_urdf(self._tmp.name)
        self._port, self._ref = {}, {}

    def port(self, device, dtype):
        from cafempc_tpu_torch.models import wbm
        key = (str(device), dtype)
        if key not in self._port:
            self._port[key] = wbm.load_model(self.urdf, device, dtype)
        return self._port[key]

    def reference(self, device, dtype):
        from benchmark.reference.plain.models import wbm
        key = (str(device), dtype)
        if key not in self._ref:
            self._ref[key] = wbm.load_model(self.urdf, device, dtype)
        return self._ref[key]

    def drop_port(self):
        self._port.clear()

    def close(self):
        self._tmp.cleanup()


# ---------------- the program (the port) ----------------------------------
def port_gait(gait):
    from cafempc_tpu_torch.reference.quad_reference import QuadReferenceData
    return QuadReferenceData(**{f.name: getattr(gait, f.name)
                                for f in dataclasses.fields(gait)})


def program_batched(cfg, gait, device, dtype, batch, models):
    from cafempc_tpu_torch import convert
    from cafempc_tpu_torch.parallel.mesh import broadcast_batch
    from cafempc_tpu_torch.problems import mhpc_problem as mp
    from cafempc_tpu_torch.reference.quad_reference import QuadReference
    from cafempc_tpu_torch.solver.options import SolverOptions
    b = cfg["batched"]
    qr = QuadReference(port_gait(gait))
    qr.initialize(_window_s(cfg))
    mcfg = mp.MHPCConfig(**cfg["settings"])
    plan_np, pen_np, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, mcfg)
    plan, pen, Xbar0, Ubar0 = convert.from_numpy(
        (plan_np, pen_np, Xbar0, Ubar0), device, dtype)
    fns = mp.make_mhpc_fns_segmented(mcfg, models.port(device, dtype))
    return dict(plan=plan, pen=broadcast_batch(pen, batch),
                Xbar0=broadcast_batch(Xbar0, batch),
                Ubar0=broadcast_batch(Ubar0, batch), fns=fns, hooks={},
                opts=SolverOptions(**b["opts"]), solver_kw=dict(b["solver"]))


def lq_stage(fns, hooks, wrap):
    """(fns, hooks) with every segment's partial callables wrapped (the
    WB linearization, the impact and SRB partials, the cost and
    constraint partials)."""
    segs = tuple(f._replace(**{n: wrap(getattr(f, n)) for n in f._fields
                               if n.endswith(("_partials", "_partial"))})
                 for f in fns.fns)
    return fns._replace(fns=segs), hooks


def program_runtime(cfg, gait, device, models):
    from cafempc_tpu_torch.problems import mhpc_problem as mp
    from cafempc_tpu_torch.reference.quad_reference import QuadReference
    from cafempc_tpu_torch.runtime.mhpc_runtime import MHPCRuntime
    from cafempc_tpu_torch.solver.options import SolverOptions
    r = cfg["replan"]
    dtype = getattr(torch, r["dtype"])
    qr = QuadReference(port_gait(gait))
    qr.initialize(_window_s(cfg))
    return MHPCRuntime(qr, mp.MHPCConfig(**cfg["settings"]),
                       SolverOptions(**r["opts"]),
                       model=models.port(device, dtype), device=device,
                       dtype=dtype, max_resets=r["max_resets"])


def runtime_answer(rt, tape):
    r = rt.result
    return dict(cost=float(r["cost"]), success=bool(r["success"]),
                Xbar=r["Xbar"], Ubar=r["Ubar"],
                tape=dict(torque=tape.torque, qJ=tape.qJ, GRF=tape.GRF,
                          feedback=tape.feedback))


# ---------------- the plain reference -------------------------------------
def reference_batched(cfg, gait, device, dtype, x0, models):
    from benchmark.reference.plain import convert
    from benchmark.reference.plain.solver.hsddp import make_solver
    from benchmark.reference.plain.solver.options import SolverOptions
    mp = ref_mp()
    b = cfg["batched"]
    qr = ref_qr.QuadReference(gait)
    qr.initialize(_window_s(cfg))
    mcfg = mp.MHPCConfig(**cfg["settings"])
    plan_np, pen_np, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, mcfg)
    plan, pen, Xbar0, Ubar0 = convert.from_numpy(
        (plan_np, pen_np, Xbar0, Ubar0), device, dtype)
    S = x0.shape[0]

    def rep(t):
        return t.unsqueeze(0).expand((S,) + tuple(t.shape)).contiguous()
    fns = mp.make_mhpc_fns_segmented(mcfg, models.reference(device, dtype))
    solve = make_solver(fns, SolverOptions(**b["opts"]), **b["solver"])
    res = solve(plan, type(pen)(*[rep(t) for t in pen]),
                x0.to(device, dtype), rep(Xbar0), rep(Ubar0))
    return (res.cost.double().cpu().numpy(), res.success.cpu().numpy(),
            res.Xbar.double().cpu().numpy(), res.K.double().cpu().numpy())


class ReferenceRuntime:
    """The reference's MHPC replans, each from a previous answer (see
    problems/hkd.py::ReferenceRuntime)."""

    def __init__(self, cfg, gait, device, dtype, models):
        from benchmark.reference.plain.solver.hsddp import make_solver
        from benchmark.reference.plain.solver.options import SolverOptions
        self.mp = mp = ref_mp()
        self.cfg, self.gait, self.device, self.dtype = cfg, gait, device, dtype
        self.mcfg = mp._default_weights(mp.MHPCConfig(**cfg["settings"]))
        fns = mp.make_mhpc_fns_segmented(self.mcfg,
                                         models.reference(device, dtype))
        opts = SolverOptions(**cfg["replan"]["opts"])
        kw = dict(fused_riccati=True, parallel_line_search=False,
                  max_resets=cfg["replan"]["max_resets"], trim_output=False)
        self.solve_init = make_solver(fns, opts, **kw)
        self.solve_rt = make_solver(fns, opts.runtime(), **kw)
        self.dt_mpc = self.mcfg.dt_mpc

    def plan(self, k):
        qr = ref_qr.QuadReference(self.gait)
        qr.initialize(_window_s(self.cfg))
        for _ in range(k):
            qr.step(self.dt_mpc)
        return self.mp.build_mhpc_plan(qr, self.mcfg)

    def _mpc_time(self, k):
        t = 0.0
        for _ in range(k):
            t += self.dt_mpc
        return t

    def _solve(self, solve, plan_np, pen_np, x, Xb, Ub):
        from benchmark.reference.plain import convert
        from benchmark.reference.plain.solver.plan import host_plan_to_device
        plan = host_plan_to_device(plan_np, self.device, self.dtype)
        pen = host_plan_to_device(pen_np, self.device, self.dtype)
        pen = type(pen)(*[a[None] for a in pen])
        batch = [convert.from_numpy(np.asarray(a)[None], self.device,
                                    self.dtype) for a in (x, Xb, Ub)]
        s = solve(plan, pen, *batch)
        out = {k: convert.to_numpy(getattr(s.traj, k)[0])
               for k in ("Xbar", "Ubar", "Y", "K")}
        out.update(cost=float(s.cost[0]), success=bool(s.success[0]))
        return out

    def answer(self, k, x, prev):
        from benchmark.reference.plain.runtime.warm_start import (
            time_aligned_warm_start)
        plan_np, pen_np, Xbar0, Ubar0, _ = self.plan(k)
        if k == 0:
            r = self._solve(self.solve_init, plan_np, pen_np, x, Xbar0, Ubar0)
        else:
            old_plan = self.plan(k - 1)[0]
            t = self._mpc_time(k)
            Xb, Ub = time_aligned_warm_start(
                old_plan.knot, t - self.dt_mpc, prev["Xbar"], prev["Ubar"],
                plan_np.knot, t, Xbar0, Ubar0)
            r = self._solve(self.solve_rt, plan_np, pen_np, x, Xb, Ub)
        st = plan_np.step
        wb = (st.active > 0) & (st.is_reset == 0) & (st.model_id == 0)
        idx = np.nonzero(wb)[0][:TAPE_STEPS]
        K = r["K"][idx]
        return dict(cost=r["cost"], success=r["success"], Xbar=r["Xbar"],
                    Ubar=r["Ubar"],
                    tape=dict(torque=r["Ubar"][idx],
                              qJ=r["Xbar"][idx][:, 6:18], GRF=r["Y"][idx],
                              feedback=K.transpose(0, 2, 1).reshape(
                                  len(idx), -1)))

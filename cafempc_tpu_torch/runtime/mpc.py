"""Receding-horizon MPC runtime for the HKD problem (port of
`cafempc_tpu/runtime/mpc.py`: `initialize`, `update`, `command_tape`).

Every dt_mpc the reference window advances and the flat knot plan is
rebuilt on the host into the same static shapes; the previous solution is
carried onto the new plan by absolute knot time
(`runtime/warm_start.py`); the solve runs at the runtime iteration caps; a command tape mirroring publish_mpc_cmd (HKDMPC.cpp:243-298) is
extracted.

Solver configuration: the JAX runtime compiles `make_solver` with its
defaults (masked resets, parallel line search, lax.scan sweep); this port
runs gathered resets, the sequential line search and the fused sweep and
linear rollout, which the JAX package pins as the same solve
(tests/test_hkd_solver.py).  The LCM `serve` loop is not ported yet.
"""
import dataclasses
import time

import numpy as np
import torch

from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.runtime.warm_start import time_aligned_warm_start
from cafempc_tpu_torch.solver.hsddp import make_solver
from cafempc_tpu_torch.solver.options import SolverOptions
from cafempc_tpu_torch.solver.plan import host_plan_to_device


# reset sites the solver gathers: a 1.0 s bound plan has 10 phase switches
MAX_RESETS = 16


@dataclasses.dataclass
class CommandTape:
    """Per-step MPC command (hkd_command_lcmt analogue)."""
    times: np.ndarray          # [n]
    controls: np.ndarray       # [n, 24]
    des_body_state: np.ndarray  # [n, 12]
    feedback: np.ndarray       # [n, 12, 12] gains on the body state
    contacts: np.ndarray       # [n, 4]
    status_times: np.ndarray   # [n, 4]
    foot_placements: np.ndarray  # [12]
    solve_info: dict


class HKDMPCRuntime:
    def __init__(self, quad_ref: QuadReference, cfg: hp.HKDConfig,
                 opts: SolverOptions, device, dtype=torch.float64):
        self.qr = quad_ref
        self.cfg = cfg
        self.device = device
        self.dtype = dtype
        fns = hp.make_hkd_fns()
        self.solve_init = make_solver(fns, opts, max_resets=MAX_RESETS)
        self.solve_rt = make_solver(fns, opts.runtime(),
                                    max_resets=MAX_RESETS)
        self.dt_mpc = cfg.nsteps_between_mpc * cfg.dt_sim
        self.mpc_time = 0.0
        self.result = None        # numpy SolveResult of scenario 0
        self.plan_np = None
        self.meta = None
        self.pf = np.zeros((4, 3))
        # solve-time telemetry (MHPCLocomotion.cpp:134-142), milliseconds
        self.last_solve_ms = 0.0
        self.avg_solve_ms = 0.0
        self.max_solve_ms = 0.0
        self._n_solves = 0

    # ---------------- solve ------------------------------------------
    def _solve(self, solve, plan_np, pen_np, x0, Xbar0, Ubar0):
        """One B=1 solve of host inputs; the time covers the device solve
        and the fetch of its result."""
        plan = host_plan_to_device(plan_np, self.device, self.dtype)
        pen = host_plan_to_device(pen_np, self.device, self.dtype)
        pen = type(pen)(*[a[None] for a in pen])
        batch = [from_numpy(np.asarray(a)[None], self.device, self.dtype)
                 for a in (x0, Xbar0, Ubar0)]
        t0 = time.perf_counter()
        res = to_numpy(solve(plan, pen, *batch))
        self._record_solve_time(t0)
        self.result = type(res)(*[a[0] if isinstance(a, np.ndarray) else
                                  type(a)(*[v[0] for v in a])
                                  for a in res])

    def _record_solve_time(self, t0):
        self.last_solve_ms = (time.perf_counter() - t0) * 1e3
        self._n_solves += 1
        self.avg_solve_ms += (self.last_solve_ms - self.avg_solve_ms) \
            / self._n_solves
        self.max_solve_ms = max(self.max_solve_ms, self.last_solve_ms)

    # ---------------- MPC steps --------------------------------------
    def initialize(self, x0):
        plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(self.qr,
                                                                self.cfg)
        self._solve(self.solve_init, plan_np, pen_np, x0, Xbar0, Ubar0)
        self.plan_np, self.meta = plan_np, meta
        self._update_foot_placement()
        return self.command_tape()

    def update(self, x_meas, dt=None):
        """One MPC re-solve at the new measured state (HKDMPC.cpp:97-166);
        dt is the elapsed MPC time since the previous solve (default
        dt_mpc)."""
        dt = self.dt_mpc if dt is None else dt
        self.qr.step(dt)
        self.mpc_time += dt
        plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(self.qr,
                                                                self.cfg)
        Xb, Ub = time_aligned_warm_start(
            self.plan_np.knot, self.mpc_time - dt, self.result.Xbar,
            self.result.Ubar, plan_np.knot, self.mpc_time, Xbar0, Ubar0)
        self._solve(self.solve_rt, plan_np, pen_np, x_meas, Xb, Ub)
        self.plan_np, self.meta = plan_np, meta
        self._update_foot_placement()
        return self.command_tape()

    # ---------------- outputs ----------------------------------------
    def _update_foot_placement(self):
        """(HKDMPC.cpp:207-240): first future swing->stance transition's
        qdummy is the commanded foothold."""
        phases = self.meta["phases"]
        Xbar = self.result.Xbar
        found = [False] * 4
        starts, j = [], 0
        for (_, _, hor, _) in phases:
            starts.append(j)
            j += hor + 1
        for i in range(min(len(phases) - 1, 5)):
            c, cn = phases[i][3], phases[i + 1][3]
            x_start_next = Xbar[starts[i + 1]]
            for leg in range(4):
                if not found[leg] and c[leg] == 0 and cn[leg] == 1:
                    self.pf[leg] = x_start_next[12 + 3 * leg:15 + 3 * leg]
                    found[leg] = True

    def command_tape(self, n_steps=None):
        cfg = self.cfg
        n = n_steps or (cfg.nsteps_between_mpc + 7)  # HKDMPC.cpp:245-246
        plan = self.plan_np
        res = self.result
        active = np.asarray(plan.step.active)
        is_reset = np.asarray(plan.step.is_reset)
        dyn_idx = np.where((active > 0) & (is_reset == 0))[0][:n]
        # status durations per dyn step's phase (HKDMPC.cpp:281)
        contacts = np.asarray(plan.step.contact)[dyn_idx]
        status = np.zeros((len(dyn_idx), 4))
        spans, j = [], 0
        for (ts, _, h, _) in self.meta["phases"]:
            spans.append((j, j + h,
                          np.asarray(self.qr.contact_duration_at_t(ts))))
            j += h + 1
        for ii, k in enumerate(dyn_idx):
            for (s0, s1, dur) in spans:
                if s0 <= k < s1:
                    status[ii] = dur
                    break
        info = dict(cost=res.info.cost_buf[:int(res.info.n_entries)],
                    dyn_feas=float(res.feas),
                    eqn_feas=float(res.max_tconstr),
                    ineq_feas=float(res.max_pconstr),
                    iters=int(res.info.iters))
        return CommandTape(
            times=self.mpc_time + np.arange(len(dyn_idx)) * cfg.dt_sim,
            controls=res.Ubar[dyn_idx],
            des_body_state=res.Xbar[dyn_idx][:, :12],
            feedback=res.K[dyn_idx][:, :12, :12],
            contacts=contacts,
            status_times=status,
            foot_placements=self.pf.reshape(12).copy(),
            solve_info=info)

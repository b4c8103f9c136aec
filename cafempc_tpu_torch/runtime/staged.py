"""The staged B=1 solve that both MPC runtimes (`runtime/mpc.py`,
`runtime/mhpc_runtime.py`) are built on, and their LCM service loop.

`StagedRuntime` owns the receding-horizon skeleton: the two solvers, at
the initialize and at the runtime iteration caps (the sequential line
search and the sweep and linear-rollout kernels, `fused_riccati=True,
parallel_line_search=False`, with the runtime's gathered resets); the
plan rebuilt on the host every update, the previous solution carried onto
it by absolute knot time (`runtime/warm_start.py`); the solve of host
inputs; the solver telemetry; the MPC clock that follows a message's
`mpctime`; and the serve loop, which solves only the newest pending state
(latest state wins).  A runtime adds its plan builder, what it keeps of a
solve, its command tape and the conversions between messages and states.

Each `initialize` and `update` is a root span (`utils/tracing.py`) whose id
is the update's id, with the stages `runtime.plan` (`qr.step` and the
plan build), `runtime.warm_start`, `runtime.upload`, `runtime.solve`,
`runtime.fetch` and `runtime.tape` under it; `timing` is computed from
their host clocks.
"""
import time

import numpy as np
import torch

from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.runtime.warm_start import time_aligned_warm_start
from cafempc_tpu_torch.solver.hsddp import make_solver
from cafempc_tpu_torch.solver.plan import host_plan_to_device
from cafempc_tpu_torch.utils import tracing


class StagedRuntime:
    """A receding-horizon runtime of one problem.  A subclass sets
    `dt_mpc` and defines `_plan`, `_fetch`, `command_tape`,
    `_message_state` and `_command`, and may define `_warm_started` and
    `_before_tape`."""

    def __init__(self, quad_ref, fns, opts, max_resets, device, dtype,
                 endpoint, debug_intermtraj, trim_output=True):
        """fns: the problem functions; opts: the initialize's solver
        options (the updates take `opts.runtime()`); max_resets: reset
        steps the solver gathers per segment; endpoint: a
        `comms.udpm.LCMEndpoint` for the solver telemetry
        (`solver_info_lcmt` on "DDP_Solver_Info"); debug_intermtraj:
        publish `solver_intermtraj_lcmt` on "intermediate_ddp_traj" after
        every AL outer iteration (MultiPhaseDDP.h:95-107); trim_output:
        solve to a `SolveResult` (else the final `SolverState`)."""
        self.qr = quad_ref
        self.endpoint = endpoint
        self.device = device
        self.dtype = dtype
        kw = dict(fused_riccati=True, parallel_line_search=False,
                  max_resets=max_resets, trim_output=trim_output,
                  iter_callback=(self._intermtraj_callback
                                 if debug_intermtraj else None))
        self.solve_init = make_solver(fns, opts, **kw)
        self.solve_rt = make_solver(fns, opts.runtime(), **kw)
        self.mpc_time = 0.0
        self.result = None        # what `_fetch` kept of the last solve
        self.plan_np = None
        self.meta = None
        self.guess = None         # (Xbar0, Ubar0) the last solve started from
        # solve-time telemetry (MHPCLocomotion.cpp:134-142), milliseconds;
        # timing: the last step's host plan build (with the warm start and
        # the copy to the device), solve and fetch
        self.last_solve_ms = 0.0
        self.timing = {}
        # serve(): solves run, states not yet solved, (endpoint, channel)
        # pairs subscribed
        self._n_served = 0
        self._serve_pending = []
        self._serve_subs = set()

    # ---------------- what a runtime adds -----------------------------
    def _warm_started(self, plan_np, meta, Xb):
        """After the warm start of an update, inside its stage."""

    def _before_tape(self):
        """After a solve, before its tape, inside the tape stage."""

    # ---------------- solve ------------------------------------------
    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _solve(self, solve, step, plan_np, pen_np, x0, Xbar0, Ubar0):
        """One B=1 solve of host inputs under the root span `step`; the
        solve time covers the device solve and the fetch of its result."""
        with tracing.stage("runtime.upload") as upload:
            plan = host_plan_to_device(plan_np, self.device, self.dtype)
            pen = host_plan_to_device(pen_np, self.device, self.dtype)
            pen = type(pen)(*[a[None] for a in pen])
            batch = [from_numpy(np.asarray(a)[None], self.device, self.dtype)
                     for a in (x0, Xbar0, Ubar0)]
            self._sync()
        with tracing.stage("runtime.solve") as solved:
            s = solve(plan, pen, *batch)
            self._sync()
        with tracing.stage("runtime.fetch") as fetch:
            self.result = self._fetch(s)
        self.guess = (Xbar0, Ubar0)
        # the host plan build runs from the step's start to the end of the
        # upload (the warm start and the copy to the device included)
        self.timing = dict(build_ms=(upload.end_ns - step.start_ns) / 1e6,
                           solve_ms=solved.ms, fetch_ms=fetch.ms)
        self.last_solve_ms = (fetch.end_ns - solved.start_ns) / 1e6

    # ---------------- MPC steps --------------------------------------
    def initialize(self, x0):
        """The full-cap solve from the plan's initial guess."""
        with tracing.stage("runtime.initialize") as step:
            with tracing.stage("runtime.plan"):
                plan_np, pen_np, Xbar0, Ubar0, meta = self._plan()
            self._solve(self.solve_init, step, plan_np, pen_np, x0, Xbar0,
                        Ubar0)
            self.plan_np, self.meta = plan_np, meta
            return self._tape()

    def update(self, x_meas, dt=None):
        """One re-solve at the measured state; dt is the elapsed MPC time
        since the previous solve (default dt_mpc)."""
        with tracing.stage("runtime.update") as step:
            with tracing.stage("runtime.plan"):
                dt = self.dt_mpc if dt is None else dt
                self.qr.step(dt)
                self.mpc_time += dt
                plan_np, pen_np, Xbar0, Ubar0, meta = self._plan()
            with tracing.stage("runtime.warm_start"):
                prev = _fields(self.result)
                Xb, Ub = time_aligned_warm_start(
                    self.plan_np.knot, self.mpc_time - dt, prev["Xbar"],
                    prev["Ubar"], plan_np.knot, self.mpc_time, Xbar0, Ubar0)
                self._warm_started(plan_np, meta, Xb)
            self._solve(self.solve_rt, step, plan_np, pen_np, x_meas, Xb, Ub)
            self.plan_np, self.meta = plan_np, meta
            return self._tape()

    def _tape(self):
        with tracing.stage("runtime.tape"):
            self._before_tape()
            self._publish_solver_info()
            return self.command_tape()

    # ---------------- telemetry --------------------------------------
    def _intermtraj_callback(self, Xbar, Ubar, it):
        """The solver's iter_callback: the current nominal trajectory as
        solver_intermtraj_lcmt (publish_trajectory,
        MultiPhaseDDP.h:95-107)."""
        if self.endpoint is not None:
            self.endpoint.publish("intermediate_ddp_traj",
                                  intermtraj_message(Xbar[0], Ubar[0]))

    def _publish_solver_info(self):
        """solver_info_lcmt telemetry (MHPCLocomotion.cpp:74-79)."""
        if self.endpoint is not None:
            self.endpoint.publish("DDP_Solver_Info", solver_info_message(
                self.result, self.last_solve_ms))

    # ---------------- LCM service ------------------------------------
    def _solve_message(self, msg):
        """initialize or update at the message's state, the MPC clock set
        to its mpctime: under latest-state-wins a dropped message must not
        leave the reference window behind the robot."""
        x = self._message_state(msg)
        delta = float(msg.mpctime) - self.mpc_time
        if msg.reset_mpc or self.result is None:
            if delta > 1e-12:
                self.qr.step(delta)
            self.mpc_time = float(msg.mpctime)
            self.initialize(x)
        else:
            self.update(x, dt=delta if delta > 1e-12 else None)

    def _serve(self, endpoint, data_channel, msg_type, cmd_channel,
               max_msgs):
        """Subscribe to `data_channel` once per endpoint, then until
        `max_msgs` states are answered (None: never) wait for a datagram,
        drain the socket, solve only the newest pending state and publish
        `_command` on `cmd_channel`.  Returns the states answered."""
        key = (id(endpoint), data_channel)
        if key not in self._serve_subs:
            endpoint.subscribe(data_channel, msg_type,
                               lambda _c, m: self._serve_pending.append(m))
            self._serve_subs.add(key)
        start = self._n_served
        while max_msgs is None or self._n_served - start < max_msgs:
            endpoint.handle(timeout=0.25)
            while endpoint.handle(timeout=0.0):   # drain the socket
                pass
            if self._serve_pending:
                msg = self._serve_pending[-1]
                self._serve_pending.clear()
                t0 = time.perf_counter()
                self._solve_message(msg)
                endpoint.publish(cmd_channel,
                                 self._command(time.perf_counter() - t0))
                self._n_served += 1
        return self._n_served - start


def intermtraj_message(Xbar, Ubar):
    """solver_intermtraj_lcmt of one scenario's nominal trajectory (Xbar
    [N+1, xs], Ubar [N, us]; the last control repeated to N+1 rows)."""
    X, U = to_numpy(Xbar), to_numpy(Ubar)
    return w.solver_intermtraj_lcmt(
        tau_sz=X.shape[0], x_sz=X.shape[1], u_sz=U.shape[1], x_tau=X,
        u_tau=np.concatenate([U, U[-1:]], axis=0))


def _fields(result):
    """A kept solve, a SolveResult or a dict of its host arrays, as a
    dict."""
    return result if isinstance(result, dict) else result._asdict()


def solver_info_message(result, solve_ms):
    """solver_info_lcmt of one scenario's solve: a SolveResult or a dict of
    its host arrays (with an `info` SolverInfo)."""
    r = _fields(result)
    info = r["info"]
    return w.solver_info_lcmt(
        n_iter=int(info.iters), n_ls_iter=int(info.ls_iters),
        n_reg_iter=int(info.reg_iters), solve_time=solve_ms,
        cost=float(r["cost"]), dyn_feas=float(r["feas"]),
        ineq_violation=float(r["max_pconstr"]),
        eq_violation=float(r["max_tconstr"]))

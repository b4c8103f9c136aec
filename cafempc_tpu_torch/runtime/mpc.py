"""Receding-horizon MPC runtime for the HKD problem and its LCM service
(port of `cafempc_tpu/runtime/mpc.py`).

Every dt_mpc the reference window advances and the flat knot plan is
rebuilt on the host into the same static shapes; the previous solution is
carried onto the new plan by absolute knot time
(`runtime/warm_start.py`); the solve runs at the runtime iteration caps; a
command tape mirroring publish_mpc_cmd (HKDMPC.cpp:243-298) is extracted
and encoded as `hkd_command_lcmt` (`command_message`).

`serve(endpoint)` is the MPC process of the reference topology
(HKDMPCSolver::run + mpcdata_lcm_handler, HKDMPC.cpp:169-205): it takes
`hkd_data_lcmt` states from the wire, solves only the newest pending one
(latest state wins), follows the message's `mpctime` with the MPC clock,
re-initializes on `reset_mpc`, and publishes the command.  With an
`endpoint` the runtime also publishes `solver_info_lcmt` after every solve
and, with `debug_intermtraj`, `solver_intermtraj_lcmt` after every AL
outer iteration.

Solver configuration: the JAX runtime compiles `make_solver` with its
defaults (masked resets, the batched line search, the sequential exact
sweep, the scan linear rollout); this runtime names its own, gathered
resets (`max_resets=MAX_RESETS`), the sequential line search and the sweep
and linear-rollout kernels (`fused_riccati=True,
parallel_line_search=False`), which the JAX package pins as the same solve
(tests/test_hkd_solver.py).

Each `initialize` and `update` is a root span (`utils/tracing.py`) whose id
is the update's id, with the stages `runtime.plan` (`qr.step` and the
plan build), `runtime.warm_start`, `runtime.upload`, `runtime.solve`,
`runtime.fetch` and `runtime.tape` (foot placement, solver-info publish,
command tape) under it; `timing` is computed from their host clocks.
"""
import dataclasses
import time

import numpy as np
import torch

from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.runtime.warm_start import time_aligned_warm_start
from cafempc_tpu_torch.solver.hsddp import make_solver
from cafempc_tpu_torch.solver.options import SolverOptions
from cafempc_tpu_torch.solver.plan import host_plan_to_device
from cafempc_tpu_torch.utils import tracing


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
                 opts: SolverOptions, device="cuda", dtype=torch.float64,
                 endpoint=None, debug_intermtraj=False):
        """device: where the solves run, the card unless the caller asks
        for the CPU; a CUDA device on a machine without one raises.
        endpoint: a `comms.udpm.LCMEndpoint` for the solver telemetry
        (`solver_info_lcmt` on "DDP_Solver_Info"); debug_intermtraj:
        publish `solver_intermtraj_lcmt` on "intermediate_ddp_traj" after
        every AL outer iteration (MultiPhaseDDP.h:95-107)."""
        if torch.device(device).type == "cuda" \
                and not torch.cuda.is_available():
            raise RuntimeError(f"HKDMPCRuntime: no CUDA device for device="
                               f"{device!r}; pass device='cpu' to run on "
                               "the CPU")
        self.endpoint = endpoint
        self.qr = quad_ref
        self.cfg = cfg
        self.device = device
        self.dtype = dtype
        fns = hp.make_hkd_fns()
        kw = dict(fused_riccati=True, parallel_line_search=False,
                  max_resets=MAX_RESETS, iter_callback=(
            self._intermtraj_callback if debug_intermtraj else None))
        self.solve_init = make_solver(fns, opts, **kw)
        self.solve_rt = make_solver(fns, opts.runtime(), **kw)
        self.dt_mpc = cfg.nsteps_between_mpc * cfg.dt_sim
        self.mpc_time = 0.0
        self.result = None        # numpy SolveResult of scenario 0
        self.plan_np = None
        self.meta = None
        self.pf = np.zeros((4, 3))
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
            res = solve(plan, pen, *batch)
            self._sync()
        with tracing.stage("runtime.fetch") as fetch:
            res = to_numpy(res)
            self.result = type(res)(*[a[0] if isinstance(a, np.ndarray) else
                                      type(a)(*[v[0] for v in a])
                                      for a in res])
        self.timing = stage_timing(step, upload, solved, fetch)
        self.last_solve_ms = (fetch.end_ns - solved.start_ns) / 1e6

    # ---------------- MPC steps --------------------------------------
    def initialize(self, x0):
        with tracing.stage("runtime.initialize") as step:
            with tracing.stage("runtime.plan"):
                plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(
                    self.qr, self.cfg)
            self._solve(self.solve_init, step, plan_np, pen_np, x0, Xbar0,
                        Ubar0)
            self.plan_np, self.meta = plan_np, meta
            return self._tape()

    def update(self, x_meas, dt=None):
        """One MPC re-solve at the new measured state (HKDMPC.cpp:97-166);
        dt is the elapsed MPC time since the previous solve (default
        dt_mpc)."""
        with tracing.stage("runtime.update") as step:
            with tracing.stage("runtime.plan"):
                dt = self.dt_mpc if dt is None else dt
                self.qr.step(dt)
                self.mpc_time += dt
                plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(
                    self.qr, self.cfg)
            with tracing.stage("runtime.warm_start"):
                Xb, Ub = time_aligned_warm_start(
                    self.plan_np.knot, self.mpc_time - dt, self.result.Xbar,
                    self.result.Ubar, plan_np.knot, self.mpc_time, Xbar0,
                    Ubar0)
            self._solve(self.solve_rt, step, plan_np, pen_np, x_meas, Xb, Ub)
            self.plan_np, self.meta = plan_np, meta
            return self._tape()

    def _tape(self):
        with tracing.stage("runtime.tape"):
            self._update_foot_placement()
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

    def command_message(self, solve_time=0.0):
        """The tape as hkd_command_lcmt (publish_mpc_cmd,
        HKDMPC.cpp:243-298).  The schema carries fixed 10-step arrays;
        shorter tapes pad by repeating the final step."""
        tape = self.command_tape(n_steps=10)
        n = min(len(tape.times), 10)

        def pad(a, shape):
            out = np.zeros(shape)
            out[:n] = np.asarray(a)[:n]
            if 0 < n < shape[0]:
                out[n:] = out[n - 1]
            return out

        return w.hkd_command_lcmt(
            N_mpcsteps=n, mpc_times=pad(tape.times, (10,)),
            hkd_controls=pad(tape.controls, (10, 24)),
            des_body_state=pad(tape.des_body_state, (10, 12)),
            contacts=pad(tape.contacts, (10, 4)).astype(np.int32),
            statusTimes=pad(tape.status_times, (10, 4)),
            foot_placement=tape.foot_placements,
            feedback=pad(tape.feedback, (10, 12, 12)), solve_time=solve_time)

    # ---------------- LCM service ------------------------------------
    def serve(self, endpoint, data_channel="mpc_data",
              cmd_channel="mpc_command", max_msgs=None):
        """Serve MPC over the wire (HKDMPCSolver::run + mpcdata_lcm_handler,
        HKDMPC.cpp:169-205): take hkd_data_lcmt from `data_channel`, solve,
        publish hkd_command_lcmt on `cmd_channel`.  States that arrive
        while a solve runs are superseded: each pass drains the socket and
        solves only the newest pending state.  Returns after `max_msgs`
        solves (None: never).  A failed solve raises."""
        def answer(msg):
            t0 = time.perf_counter()
            self._solve_message(msg)
            endpoint.publish(cmd_channel, self.command_message(
                solve_time=time.perf_counter() - t0))

        return serve_newest(self, endpoint, data_channel, w.hkd_data_lcmt,
                            answer, max_msgs)

    def _solve_message(self, msg):
        """initialize or update at the message's state, the MPC clock set
        to its mpctime (HKDMPC.cpp:188): under latest-state-wins a dropped
        message must not leave the reference window behind the robot.  The
        state is [eul (yaw, pitch, roll), p, omegaBody, vWorld, qdummy],
        qdummy from the joint angles and the contact by
        `hkd.compute_hkd_state` on the runtime's device."""
        body = np.concatenate([np.asarray(msg.rpy)[::-1], msg.p,
                               msg.omegaBody, msg.vWorld]).astype(float)

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=float),
                                   dtype=self.dtype, device=self.device)

        qdummy = hkd.compute_hkd_state(dev(body[0:3]), dev(body[3:6]),
                                       dev(msg.qJ), dev(msg.contact))
        x = np.concatenate([body, to_numpy(qdummy)])
        delta = float(msg.mpctime) - self.mpc_time
        if msg.reset_mpc or self.result is None:
            if delta > 1e-12:
                self.qr.step(delta)
            self.mpc_time = float(msg.mpctime)
            self.initialize(x)
        else:
            self.update(x, dt=delta if delta > 1e-12 else None)

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


def stage_timing(step, upload, solved, fetch):
    """The runtimes' `timing` (ms) from their stage spans: the host plan
    build from the step's start to the end of the upload (the warm start
    and the copy to the device included), the solve, the fetch."""
    return dict(build_ms=(upload.end_ns - step.start_ns) / 1e6,
                solve_ms=solved.ms, fetch_ms=fetch.ms)


def intermtraj_message(Xbar, Ubar):
    """solver_intermtraj_lcmt of one scenario's nominal trajectory (Xbar
    [N+1, xs], Ubar [N, us]; the last control repeated to N+1 rows)."""
    X, U = to_numpy(Xbar), to_numpy(Ubar)
    return w.solver_intermtraj_lcmt(
        tau_sz=X.shape[0], x_sz=X.shape[1], u_sz=U.shape[1], x_tau=X,
        u_tau=np.concatenate([U, U[-1:]], axis=0))


def solver_info_message(result, solve_ms):
    """solver_info_lcmt of one scenario's solve: a SolveResult or a dict of
    its host arrays (with an `info` SolverInfo)."""
    r = result if isinstance(result, dict) else result._asdict()
    info = r["info"]
    return w.solver_info_lcmt(
        n_iter=int(info.iters), n_ls_iter=int(info.ls_iters),
        n_reg_iter=int(info.reg_iters), solve_time=solve_ms,
        cost=float(r["cost"]), dyn_feas=float(r["feas"]),
        ineq_violation=float(r["max_pconstr"]),
        eq_violation=float(r["max_tconstr"]))


def serve_newest(rt, endpoint, data_channel, msg_type, answer, max_msgs):
    """The serve loop of both runtimes: subscribe rt to `data_channel` once
    per endpoint, then until `max_msgs` states are answered (None: never)
    wait for a datagram, drain the socket, and answer(msg) only the newest
    pending state (latest state wins).  Returns the states answered."""
    key = (id(endpoint), data_channel)
    if key not in rt._serve_subs:
        endpoint.subscribe(data_channel, msg_type,
                           lambda _c, m: rt._serve_pending.append(m))
        rt._serve_subs.add(key)
    start = rt._n_served
    while max_msgs is None or rt._n_served - start < max_msgs:
        endpoint.handle(timeout=0.25)
        while endpoint.handle(timeout=0.0):   # drain the socket
            pass
        if rt._serve_pending:
            msg = rt._serve_pending[-1]
            rt._serve_pending.clear()
            answer(msg)
            rt._n_served += 1
    return rt._n_served - start

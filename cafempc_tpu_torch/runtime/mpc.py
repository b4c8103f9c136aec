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

The staged solve, its spans and `timing`, the telemetry and the serve loop
are `runtime/staged.py`'s; the foot placement runs in the `runtime.tape`
stage, before the solver-info publish and the command tape.
"""
import dataclasses

import numpy as np
import torch

from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.convert import to_numpy
from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.runtime.staged import StagedRuntime
from cafempc_tpu_torch.solver.options import SolverOptions


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


class HKDMPCRuntime(StagedRuntime):
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
        self.cfg = cfg
        self.dt_mpc = cfg.nsteps_between_mpc * cfg.dt_sim
        self.pf = np.zeros((4, 3))
        super().__init__(quad_ref, hp.make_hkd_fns(), opts, MAX_RESETS,
                         device, dtype, endpoint, debug_intermtraj)

    def _plan(self):
        return hp.build_hkd_plan(self.qr, self.cfg)

    def _fetch(self, res):
        """`result`: the numpy SolveResult of scenario 0."""
        res = to_numpy(res)
        return type(res)(*[a[0] if isinstance(a, np.ndarray) else
                           type(a)(*[v[0] for v in a]) for a in res])

    # ---------------- outputs ----------------------------------------
    def _before_tape(self):
        """The foot placement (HKDMPC.cpp:207-240): the first future
        swing->stance transition's qdummy is the commanded foothold."""
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
        return self._serve(endpoint, data_channel, w.hkd_data_lcmt,
                           cmd_channel, max_msgs)

    def _command(self, solve_s):
        return self.command_message(solve_time=solve_s)

    def _message_state(self, msg):
        """The state [eul (yaw, pitch, roll), p, omegaBody, vWorld, qdummy]
        of an hkd_data_lcmt (HKDMPC.cpp:188), qdummy from the joint angles
        and the contact by `hkd.compute_hkd_state` on the runtime's
        device."""
        body = np.concatenate([np.asarray(msg.rpy)[::-1], msg.p,
                               msg.omegaBody, msg.vWorld]).astype(float)

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=float),
                                   dtype=self.dtype, device=self.device)

        qdummy = hkd.compute_hkd_state(dev(body[0:3]), dev(body[3:6]),
                                       dev(msg.qJ), dev(msg.contact))
        return np.concatenate([body, to_numpy(qdummy)])

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


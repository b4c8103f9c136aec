"""Receding-horizon MPC runtime for the cascaded MHPC problem and its LCM
service (port of `cafempc_tpu/runtime/mhpc_runtime.py`).

Functional equivalent of the reference MHPCLocomotion
(MHPC/MHPCLocomotion.cpp): initialize() does the full-cap solve; update()
steps the reference window by dt, rebuilds the flat cascaded plan on the
host (the reference's update_WB_plan/update_SRB_plan deque surgery,
MHPCProblem.cpp:252-397), warm-starts from the previous solution by
absolute knot time (`runtime/warm_start.py`) and re-solves at the runtime
iteration caps.  `command_tape()` is publish_mpc_cmd's 8-step tape
(MHPCLocomotion.cpp:190-287): x, tau, GRF, Qu, Quu, Qux and the feedback
K of the first WB dynamics steps, the matrices flattened column-major as
the reference's Eigen .data() copies are; `command_message()` encodes it
as `MHPC_Command_lcmt`.

`serve(endpoint)` is the MPC process of the reference topology
(MHPCLocomotion::run + mpcdata_lcm_handler, MHPCLocomotion.cpp:90-187):
it takes `MHPC_Data_lcmt` states from the wire, solves only the newest
pending one (latest state wins), follows the message's `mpctime` with the
MPC clock, re-initializes on `reset_mpc`, publishes the command, and
adopts its endpoint for the telemetry: `solver_info_lcmt` after every
solve and, with `debug_intermtraj`, `solver_intermtraj_lcmt` after every
AL outer iteration.

The runtime takes the robot (a `wbm` model or a URDF path); the JAX
runtime always loads the default URDF (mhpc_runtime.py:52).  Solver
configuration: the JAX runtime compiles `make_solver` with its defaults
(masked resets, the batched line search, the sequential exact sweep, the
scan linear rollout); this runtime names its own, gathered resets
(`max_resets`), the sequential line search and the sweep and
linear-rollout kernels (`fused_riccati=True, parallel_line_search=False`),
which the JAX package pins as the same solve.

The staged solve, its spans and `timing`, the telemetry and the serve loop
are `runtime/staged.py`'s; the optional foot handoff runs in the
`runtime.warm_start` stage, after the warm start.
"""
import dataclasses

import numpy as np
import torch

from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.convert import to_numpy
from cafempc_tpu_torch.models import wbm
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.runtime.staged import StagedRuntime
from cafempc_tpu_torch.solver.options import SolverOptions


@dataclasses.dataclass
class MHPCCommandTape:
    """MHPC_Command_lcmt's fields (MHPCLocomotion.cpp:190-287) as numpy
    arrays, one row per commanded step; Quu, Qux and feedback flattened
    column-major."""
    mpc_times: np.ndarray      # [n]
    torque: np.ndarray         # [n, 12]
    pos: np.ndarray            # [n, 3]
    eul: np.ndarray            # [n, 3]
    qJ: np.ndarray             # [n, 12]
    vWorld: np.ndarray         # [n, 3]
    eulrate: np.ndarray        # [n, 3]
    qJd: np.ndarray            # [n, 12]
    GRF: np.ndarray            # [n, 12]
    feedback: np.ndarray       # [n, 12 * 36]
    Qu: np.ndarray             # [n, 12]
    Quu: np.ndarray            # [n, 12 * 12]
    Qux: np.ndarray            # [n, 12 * 36]
    contacts: np.ndarray       # [n, 4] int32
    statusTimes: np.ndarray    # [n, 4]


# the solver arrays the runtime keeps of each solve (scenario 0), host-side
_KEPT = ("Xbar", "Ubar", "Y", "K", "Qu", "Quu", "Qux")


class MHPCRuntime(StagedRuntime):
    def __init__(self, quad_ref: QuadReference, cfg: mp.MHPCConfig,
                 opts: SolverOptions, model=None, urdf_path=None,
                 device="cuda", dtype=torch.float64, n_cmd_steps=8,
                 segmented=None, max_resets=8, foot_handoff=False,
                 endpoint=None, debug_intermtraj=False):
        """model: the whole-body model (`wbm.load_model`) at `device` and
        `dtype`, or urdf_path to load it from; segmented: solve with the
        two-segment functions (None: whenever the plan has an SRB tail) or,
        False, with the joint-mode functions (`mp.make_mhpc_fns`);
        max_resets: reset steps gathered per segment (the joint functions
        are one segment); foot_handoff: freeze the solved WB foot XY
        into the SRB tail for feet in stance at the handoff
        (MHPCFootStep.h:26-57, opt-in, see
        mhpc_problem.apply_transition_foot_handoff); endpoint: a
        `comms.udpm.LCMEndpoint` for the telemetry (`serve` adopts its own
        where this is None); debug_intermtraj: publish
        solver_intermtraj_lcmt on "intermediate_ddp_traj" after every AL
        outer iteration (MultiPhaseDDP.h:95-107)."""
        if model is None:
            if urdf_path is None:
                raise ValueError("MHPCRuntime needs the robot: a wbm model "
                                 "or a URDF path")
            model = wbm.load_model(urdf_path, device, dtype)
        self.cfg = mp._default_weights(cfg)
        self.dt_mpc = self.cfg.dt_mpc
        self.model = model
        self.n_cmd_steps = n_cmd_steps
        self.foot_handoff = foot_handoff
        if segmented or (segmented is None and cfg.plan_dur_srb > 0):
            fns = mp.make_mhpc_fns_segmented(cfg, model)
        elif segmented is None:
            # no SRB tail: the WB functions compute the joint functions'
            # values (the JAX runtime takes the joint ones)
            fns = mp.make_mhpc_fns(cfg, model, "wb")
        else:
            fns = mp.make_mhpc_fns(cfg, model)
        super().__init__(quad_ref, fns, opts, max_resets, device, dtype,
                         endpoint, debug_intermtraj, trim_output=False)

    def _plan(self):
        return mp.build_mhpc_plan(self.qr, self.cfg)

    def _fetch(self, s):
        """`result`: a dict of scenario 0's kept solver arrays."""
        res = {k: to_numpy(getattr(s.traj, k)[0]) for k in _KEPT}
        res.update({k: to_numpy(getattr(s, k)[0]) for k in (
            "cost", "feas", "max_pconstr", "max_tconstr", "success")})
        res["info"] = type(s.info)(*[to_numpy(a[0]) for a in s.info])
        return res

    def _warm_started(self, plan_np, meta, Xb):
        if self.foot_handoff and meta["srb_horizon"] > 0:
            # state entering the WB->SRB model-switch reset (warm-started)
            mp.apply_transition_foot_handoff(
                plan_np, self.cfg, Xb[self.cfg.wb_block - 1], self.model)

    # ---------------- outputs ----------------------------------------
    def command_tape(self):
        """The first n_cmd_steps WB dynamics steps of the solution
        (MHPCLocomotion.cpp:190-287)."""
        st = self.plan_np.step
        r = self.result
        wb = (st.active > 0) & (st.is_reset == 0) & (st.model_id == 0)
        idx = np.nonzero(wb)[0][:self.n_cmd_steps]
        n = len(idx)
        X = r["Xbar"][idx]

        def colmajor(M):
            return M[idx].transpose(0, 2, 1).reshape(n, -1)

        # statusTimes[k]: contact durations of the WB phase owning step k
        # (MHPCLocomotion.cpp:264)
        status = np.zeros((n, 4))
        for ii, k in enumerate(idx):
            for (ts, te, _, _) in self.meta["wb_phases"]:
                if ts - 1e-9 <= st.t[k] < te - 1e-9:
                    status[ii] = self.qr.contact_duration_at_t(ts)
                    break
        return MHPCCommandTape(
            mpc_times=self.mpc_time + st.t[idx], torque=r["Ubar"][idx],
            pos=X[:, 0:3], eul=X[:, 3:6], qJ=X[:, 6:18], vWorld=X[:, 18:21],
            eulrate=X[:, 21:24], qJd=X[:, 24:36], GRF=r["Y"][idx],
            feedback=colmajor(r["K"]), Qu=r["Qu"][idx],
            Quu=colmajor(r["Quu"]), Qux=colmajor(r["Qux"]),
            contacts=st.contact[idx].astype(np.int32), statusTimes=status)

    def command_message(self):
        """The command tape as MHPC_Command_lcmt (MHPCLocomotion.cpp:
        190-287)."""
        tape = self.command_tape()
        return w.MHPC_Command_lcmt(N_mpcsteps=len(tape.mpc_times),
                                   **dataclasses.asdict(tape))

    # ---------------- LCM service ------------------------------------
    def serve(self, endpoint, data_channel="MHPC_DATA",
              cmd_channel="MHPC_COMMAND", max_msgs=None):
        """Serve MPC over the wire (MHPCLocomotion::run +
        mpcdata_lcm_handler, MHPCLocomotion.cpp:90-187): take
        MHPC_Data_lcmt from `data_channel`, solve, publish
        MHPC_Command_lcmt on `cmd_channel`.  States that arrive while a
        solve runs are superseded: each pass drains the socket and solves
        only the newest pending state.  Without a telemetry endpoint the
        runtime adopts this one.  Returns after `max_msgs` solves (None:
        never).  A failed solve raises."""
        if self.endpoint is None:
            self.endpoint = endpoint
        return self._serve(endpoint, data_channel, w.MHPC_Data_lcmt,
                           cmd_channel, max_msgs)

    def _command(self, solve_s):
        return self.command_message()

    def _message_state(self, msg):
        """The state [pos, eul, qJ, vWorld, eulrate, qJd] of an
        MHPC_Data_lcmt (MHPCLocomotion.cpp:163-172)."""
        return np.concatenate([msg.pos, msg.eul, msg.qJ, msg.vWorld,
                               msg.eulrate, msg.qJd]).astype(float)

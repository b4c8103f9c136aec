"""Two-process MHPC over the LCM wire (port of `examples/two_process_mhpc.py`).

    python -m cafempc_tpu_torch.examples.two_process_mhpc \\
        [--role both|mpc|sim] [--steps 5] [--device cuda|cpu] \\
        [--transport udpm|native]

The reference's flagship process topology (SURVEY §1: sim / whole-body
controller <-> mhpc_run over LCM UDP multicast, channels "MHPC_DATA" /
"MHPC_COMMAND", MHPCLocomotion.cpp:36,282): the MPC role serves
`MHPCRuntime` on `--device`; the sim role stands in for the robot,
integrating the whole-body dynamics (`models/wbm.dynamics`) under the
commanded torque tape and feedback, u = u_ff + K (x - x_des) with K read
column-major, and streams its state back.  `--role both` starts the MPC
role as a child process and runs the sim.

Robot and gait are the synthetic quadruped (`models/synthetic_robot.py`)
and the urdf-order synthetic bound reference; the plan is the JAX
example's (WB 0.1 s, SRB 0.2 s, 24 steps, WB block 16).  The sim matches
commands to states, prints its figures and fails as the HKD example's
does (`two_process_hkd_mpc`).
"""
import json
import tempfile
import time

import numpy as np
import torch

from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.examples.two_process_hkd_mpc import (
    Z_RANGE, check_device, make_endpoint, run_roles, wait_command)
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import \
    synthetic_bound_reference_urdf
from cafempc_tpu_torch.runtime.mhpc_runtime import MHPCRuntime
from cafempc_tpu_torch.solver.options import SolverOptions

PLAN_DUR_WB = 0.1
PLAN_DUR_SRB = 0.2
WB_BLOCK = 16
N_MAX = 24
DT_WB = 0.01
DT_MPC = 0.02
WINDOW = 0.4
OPTS = dict(max_AL_iter=2, max_DDP_iter=2, max_AL_iter_runtime=1,
            max_DDP_iter_runtime=1)
REF_DURATION = 6.0
MODULE = "cafempc_tpu_torch.examples.two_process_mhpc"


def load_robot(device, dtype=torch.float64):
    """The synthetic quadruped's whole-body model, from a URDF written to
    a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        return wbm.load_model(
            synthetic_robot.write_synthetic_quadruped_urdf(tmp), device, dtype)


def reference():
    qr = QuadReference(synthetic_bound_reference_urdf(duration=REF_DURATION))
    qr.initialize(WINDOW)
    return qr


def run_mpc(device, transport, max_msgs=None):
    """MPC role: MHPC_Data in -> cascaded solve -> MHPC_COMMAND out."""
    check_device(device)
    cfg = mp.MHPCConfig(plan_dur_wb=PLAN_DUR_WB, plan_dur_srb=PLAN_DUR_SRB,
                        n_steps_max=N_MAX, wb_block=WB_BLOCK, dt_mpc=DT_MPC,
                        dt_wb=DT_WB)
    rt = MHPCRuntime(reference(), cfg, SolverOptions(**OPTS),
                     model=load_robot(device), device=device)
    ep = make_endpoint(transport)
    print(f"[mpc] serving MHPC_DATA -> MHPC_COMMAND on {device}", flush=True)
    try:
        rt.serve(ep, max_msgs=max_msgs)
    finally:
        ep.close()


def run_sim(n_mpc_steps, device, transport, republish_s=1.5):
    """Sim role: publish the WB state, wait for its command, integrate
    DT_MPC / DT_WB steps of DT_WB under it; repeat (the first state is
    re-published as in the HKD example).  Returns the per-step figures."""
    check_device(device)
    model = load_robot(device)
    f64 = dict(dtype=torch.float64, device=device)
    x = np.asarray(wb_state_ref_at(reference(), 0.0), dtype=float)
    ep = make_endpoint(transport)
    cmds = []
    ep.subscribe("MHPC_COMMAND", w.MHPC_Command_lcmt,
                 lambda _c, m: cmds.append((time.perf_counter(), m)))
    mpctime = 0.0
    steps = []

    def publish_state(reset):
        ep.publish("MHPC_DATA", w.MHPC_Data_lcmt(
            reset_mpc=reset, MS=True, mpctime=mpctime, pos=x[0:3],
            eul=x[3:6], qJ=x[6:18], vWorld=x[18:21], eulrate=x[21:24],
            qJd=x[24:36]))
        return time.perf_counter()

    try:
        t_pub = publish_state(True)
        for it in range(n_mpc_steps):
            t_recv, cmd = wait_command(ep, cmds, mpctime, DT_WB, republish_s,
                                       publish_state if it == 0 else None)
            t_cmd = mpctime
            for k in range(int(round(DT_MPC / DT_WB))):
                # feedback is flattened column-major (Eigen .data() layout)
                K = cmd.feedback[k].reshape(36, 12).T
                x_des = np.concatenate([cmd.pos[k], cmd.eul[k], cmd.qJ[k],
                                        cmd.vWorld[k], cmd.eulrate[k],
                                        cmd.qJd[k]])
                u = cmd.torque[k] + K @ (x - x_des)
                x = wbm.dynamics(model, torch.tensor(x, **f64),
                                 torch.tensor(u, **f64), DT_WB,
                                 torch.tensor(cmd.contacts[k], **f64))[0]
                x = x.cpu().numpy()
                mpctime += DT_WB
            steps.append(dict(t=t_cmd, z=float(x[2]),
                              latency_ms=(t_recv - t_pub) * 1e3))
            print(f"[sim] t={mpctime:.2f} z={x[2]:.3f} latency "
                  f"{steps[-1]['latency_ms']:.1f} ms statusTimes[0]="
                  f"{cmd.statusTimes[0]}", flush=True)
            if not Z_RANGE[0] < x[2] < Z_RANGE[1]:
                raise SystemExit(f"[sim] body height diverged: z={x[2]:.3f}")
            t_pub = publish_state(False)
    finally:
        ep.close()
    print(json.dumps({"sim": {"steps": steps}}), flush=True)
    print("[sim] done: closed-loop MHPC over the wire", flush=True)
    return steps


def main(argv=None):
    run_roles(argv, __doc__, 5, MODULE, run_mpc, run_sim)


if __name__ == "__main__":
    main()

"""Two-process HKD-MPC over the LCM wire (port of
`examples/two_process_hkd_mpc.py`).

    python -m cafempc_tpu_torch.examples.two_process_hkd_mpc \\
        [--role both|mpc|sim] [--steps 20] [--device cuda|cpu] \\
        [--transport udpm|native]

The reference's process topology (SURVEY §1: sim <-> MPC over LCM UDP
multicast, channels "mpc_data" / "mpc_command", HKDMPC.h:42): the MPC
role serves `HKDMPCRuntime` on `--device`; the sim role stands in for the
robot, integrating the HKD dynamics under the commanded controls and
feedback, u = u_ff + K (x_body - x_des), and streams its state back.
`--role both` starts the MPC role as a child process and runs the sim.

The gait is the synthetic bound reference (`reference/synthetic.py`).
The sim waits for the command answering its latest state (its
`mpc_times[0]` is the state's `mpctime`) and drops older ones; it prints
one line per MPC step with the latency from publishing the state to
receiving its command, and a last line `{"sim": {...}}` with every step's
figures.  It fails (exit 1) when the body height leaves (0.05, 0.6) m or
no command comes.  The device and the transport are the caller's choice:
`--device cuda` without a CUDA device refuses to start.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.comms import native
from cafempc_tpu_torch.comms.udpm import LCMEndpoint, UDPMulticast
from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.reference.synthetic import synthetic_bound_reference
from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
from cafempc_tpu_torch.solver.options import SolverOptions

PLAN_DUR = 0.4
N_MAX = 48
DT_SIM = 0.01
NSTEPS_MPC = 2
OPTS = dict(max_AL_iter=3, max_DDP_iter=3, max_AL_iter_runtime=2,
            max_DDP_iter_runtime=1)
REF_DURATION = 6.0      # s of gait: ~5 s of robot time at the 1.0 s plan
Z_RANGE = (0.05, 0.6)   # body height the sim accepts [m]
WAIT_S = 900.0          # longest wait for one command
ROOT = Path(__file__).resolve().parents[2]
MODULE = "cafempc_tpu_torch.examples.two_process_hkd_mpc"


def check_device(device):
    """Refuse a CUDA device on a machine without one."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {device}; pass "
                         "--device cpu to run on the CPU")


def make_endpoint(transport):
    return LCMEndpoint(native.NativeUDPMulticast() if transport == "native"
                       else UDPMulticast())


def run_mpc(device, transport, max_msgs=None):
    """MPC role: hkd_data in -> solve -> hkd_command out."""
    check_device(device)
    qr = QuadReference(synthetic_bound_reference(duration=REF_DURATION))
    qr.initialize(PLAN_DUR)
    cfg = hp.HKDConfig(plan_duration=PLAN_DUR, n_steps_max=N_MAX,
                       dt_sim=DT_SIM, nsteps_between_mpc=NSTEPS_MPC)
    rt = HKDMPCRuntime(qr, cfg, SolverOptions(**OPTS), device=device)
    ep = make_endpoint(transport)
    print(f"[mpc] serving mpc_data -> mpc_command on {device}", flush=True)
    try:
        rt.serve(ep, max_msgs=max_msgs)
    finally:
        ep.close()


def initial_state(device):
    """Standing state: z 0.2486 m, joints (0, -0.8, 1.6), all feet down."""
    body = np.zeros(12)
    body[5] = 0.2486
    qJ = np.array([0.0, -0.8, 1.6] * 4)
    contact = np.ones(4)
    t = dict(dtype=torch.float64, device=device)
    qd = hkd.compute_hkd_state(
        torch.tensor(body[0:3], **t), torch.tensor(body[3:6], **t),
        torch.tensor(qJ, **t), torch.tensor(contact, **t))
    return np.concatenate([body, qd.cpu().numpy()]), qJ, contact


def run_sim(n_mpc_steps, device, transport, republish_s=1.5):
    """Sim role: publish the state, wait for its command, integrate
    NSTEPS_MPC steps of DT_SIM under it; repeat.  While no command has
    come, the first (reset) state is published again every `republish_s`
    s (0: never), as the MPC process may still be starting.  Returns the
    per-step figures."""
    check_device(device)
    f64 = dict(dtype=torch.float64, device=device)
    x, qJ, contact = initial_state(device)
    ep = make_endpoint(transport)
    cmds = []
    ep.subscribe("mpc_command", w.hkd_command_lcmt,
                 lambda _c, m: cmds.append((time.perf_counter(), m)))
    mpctime = 0.0
    steps = []

    def publish_state(reset):
        ep.publish("mpc_data", w.hkd_data_lcmt(
            reset_mpc=reset, MS=True, mpctime=mpctime,
            contact=contact.astype(np.int32), rpy=x[0:3][::-1], p=x[3:6],
            omegaBody=x[6:9], vWorld=x[9:12], qJ=qJ,
            foot_placements=x[12:24]))
        return time.perf_counter()

    try:
        t_pub = publish_state(True)
        for it in range(n_mpc_steps):
            t_recv, cmd = wait_command(ep, cmds, mpctime, DT_SIM, republish_s,
                                       publish_state if it == 0 else None)
            t_cmd = mpctime
            for k in range(NSTEPS_MPC):
                u = np.array(cmd.hkd_controls[k], dtype=float)
                dx = x[:12] - cmd.des_body_state[k]
                u[:12] += cmd.feedback[k] @ dx
                contact = np.asarray(cmd.contacts[k], dtype=float)
                x = hkd.dynamics(torch.tensor(x, **f64),
                                 torch.tensor(u, **f64),
                                 torch.tensor(DT_SIM, **f64),
                                 torch.tensor(contact, **f64)).cpu().numpy()
                mpctime += DT_SIM
            steps.append(dict(t=t_cmd, z=float(x[5]),
                              latency_ms=(t_recv - t_pub) * 1e3,
                              solve_ms=float(cmd.solve_time) * 1e3))
            print(f"[sim] t={mpctime:.2f} z={x[5]:.3f} latency "
                  f"{steps[-1]['latency_ms']:.1f} ms (solve "
                  f"{steps[-1]['solve_ms']:.1f} ms)", flush=True)
            if not Z_RANGE[0] < x[5] < Z_RANGE[1]:
                raise SystemExit(f"[sim] body height diverged: z={x[5]:.3f}")
            t_pub = publish_state(False)
    finally:
        ep.close()
    print(json.dumps({"sim": {"steps": steps}}), flush=True)
    print("[sim] done: closed-loop stable over the wire", flush=True)
    return steps


def wait_command(ep, cmds, mpctime, dt, republish_s, republish=None):
    """The (receive time, command) answering the state at `mpctime` (its
    mpc_times[0] within dt / 2) from `cmds`, which ep's handler fills;
    older commands are dropped.  While waiting, republish(True) runs every
    `republish_s` s (0: never)."""
    t_end = time.perf_counter() + WAIT_S
    t_next = time.perf_counter() + republish_s
    while time.perf_counter() < t_end:
        ep.handle(timeout=0.05)
        while cmds:
            t_recv, cmd = cmds.pop(0)
            if abs(cmd.mpc_times[0] - mpctime) < 0.5 * dt:
                return t_recv, cmd
        if republish and republish_s and time.perf_counter() > t_next:
            republish(True)
            t_next = time.perf_counter() + republish_s
    raise SystemExit(f"[sim] no command for t={mpctime:.2f} within "
                     f"{WAIT_S:.0f} s")


def run_roles(argv, doc, steps, module, run_mpc, run_sim):
    """The command line of a two-process example: parse `argv`, refuse a
    CUDA device where there is none, run the role (`both`: the mpc role
    as a child process of `module`, the sim here)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--role", choices=["mpc", "sim", "both"], default="both")
    ap.add_argument("--steps", type=int, default=steps,
                    help="MPC steps of the sim; solves of the mpc role "
                    "(0: serve until stopped)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--transport", choices=["udpm", "native"],
                    default="udpm")
    ap.add_argument("--republish-s", type=float, default=1.5,
                    help="sim: s between re-publishes of the first state "
                    "while no command has come (0: never)")
    args = ap.parse_args(argv)
    check_device(args.device)
    if args.role == "mpc":
        run_mpc(args.device, args.transport, args.steps or None)
        return
    if args.role == "sim":
        run_sim(args.steps, args.device, args.transport, args.republish_s)
        return
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    child = subprocess.Popen(
        [sys.executable, "-m", module, "--role", "mpc", "--steps", "0",
         "--device", args.device, "--transport", args.transport], env=env)
    try:
        run_sim(args.steps, args.device, args.transport, args.republish_s)
    finally:
        child.terminate()
        child.wait(timeout=30)


def main(argv=None):
    run_roles(argv, __doc__, 20, MODULE, run_mpc, run_sim)


if __name__ == "__main__":
    main()

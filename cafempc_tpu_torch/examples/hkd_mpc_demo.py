"""Closed-loop HKD-MPC demo (port of `examples/hkd_mpc_demo.py`).

    python -m cafempc_tpu_torch.examples.hkd_mpc_demo --out DIR \\
        [--gait pace|bound] [--ref CSV] [--settings-dir DIR] [--steps 15]
        [--device cuda|cpu]

Receding-horizon solves of `HKDMPCRuntime` on `--device` against a
simulated plant, the HKD model itself (`models/hkd.py`'s discrete
dynamics under the commanded controls, and its reset map where the contact
changes between two solves), then the gait and convergence plots
(`viz/plots.py`) in `--out`.  Settings: `--settings-dir` is laid out like
the reference root, and the demo reads
`HKDMPC/settings/{constraint_params,ddp_setting}.info` there as the JAX
demo does; without it, the in-code defaults (`HKDConfig()`,
`SolverOptions()`).  Either way the JAX demo's budget (3 AL x 6 DDP)
applies, and the demo prints which source it used.  The gait: `--ref`, a
quad_reference.csv in the reference's leg order (read with reorder=True,
as the JAX demo reads its own); else
`--gait pace` (the default) generated on the synthetic quadruped
(`reference/generator.py`) into `--out/<gait>/quad_reference.csv`, or
`--gait bound`, the synthetic bound reference (`reference/synthetic.py`).
Results on them are not the robot's.  Prints one line per MPC step and a
JSON line `{"hkd_mpc_demo": {...}}`; exits 1 when the body height leaves
(0.05, 0.6) m or a cost is not finite.  `--device cuda` without a CUDA
device refuses to start.
"""
import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from cafempc_tpu_torch.examples.two_process_hkd_mpc import check_device
from cafempc_tpu_torch.models import hkd, synthetic_robot, wbm
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference import generator
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        load_quad_reference)
from cafempc_tpu_torch.reference.synthetic import synthetic_bound_reference
from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
from cafempc_tpu_torch.solver.options import (SolverOptions,
                                              load_solver_options)

BUDGET = dict(max_DDP_iter=6, max_AL_iter=3)   # the JAX demo's budget
OPTS = SolverOptions(**BUDGET)
Z_RANGE = (0.05, 0.6)     # body height the loop accepts [m]
GEN_KW = dict(vx=0.5, transition_time=0.6)


def settings(settings_dir=None):
    """(HKDConfig, SolverOptions with the demo's budget, source) from
    `settings_dir`/HKDMPC/settings, or from the in-code defaults."""
    if settings_dir is None:
        return hp.HKDConfig(), OPTS, \
            f"in-code defaults: HKDConfig(), SolverOptions() with {BUDGET}"
    d = os.path.join(settings_dir, "HKDMPC", "settings")
    cfg = hp.load_hkd_constraint_params(
        os.path.join(d, "constraint_params.info"), hp.HKDConfig())
    opts = dataclasses.replace(
        load_solver_options(os.path.join(d, "ddp_setting.info")), **BUDGET)
    return cfg, opts, f"{d} with {BUDGET}"


def reference(gait, ref_csv, out, device, duration):
    """The gait's QuadReferenceData in the HKD's leg order: a user's CSV,
    the synthetic bound, or a gait generated on the synthetic quadruped
    (on `device`) and written into `out`."""
    if ref_csv is not None:
        return load_quad_reference(ref_csv, reorder=True)
    if gait == "bound":
        return synthetic_bound_reference(duration=duration)
    model = wbm.load_model(synthetic_robot.write_synthetic_quadruped_urdf(
        out), device, torch.float64)
    path = os.path.join(out, gait, "quad_reference.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    generator.write_quad_reference_csv(generator.generate_reference(
        gait, duration=duration, model=model, **GEN_KW), path)
    return load_quad_reference(path, reorder=True)


def initial_state(qr, device):
    """Standing state (the JAX demo's): z 0.2486 m, joints (0, -0.8, 1.6),
    the reference's first contact."""
    body = np.zeros(12)
    body[5] = 0.2486
    t = dict(dtype=torch.float64, device=device)
    qd = hkd.compute_hkd_state(
        torch.tensor(body[0:3], **t), torch.tensor(body[3:6], **t),
        torch.tensor([0.0, -0.8, 1.6] * 4, **t),
        torch.tensor(np.asarray(qr.contact_at_t(0.0), float), **t))
    return np.concatenate([body, qd.cpu().numpy()])


def closed_loop(rt, x, steps, on_step=None):
    """initialize at x, then `steps` times: integrate the plant over
    nsteps_between_mpc steps of dt_sim under the tape's controls and
    contacts, apply the reset map where the next solve's first contact
    differs, and update at the new state.  on_step(i, x, tape) after each
    update.  Returns the states [steps + 1, 24] and the last tape."""
    cfg, dev = rt.cfg, rt.device

    def t(a):
        return torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                               device=dev)

    dt = t(cfg.dt_sim)
    tape = rt.initialize(x)
    history = [x.copy()]
    for it in range(steps):
        xt = t(x)
        for k in range(cfg.nsteps_between_mpc):
            xt = hkd.dynamics(xt, t(tape.controls[k]), dt,
                              t(tape.contacts[k]))
        c_next = np.asarray(rt.qr.contact_at_t(rt.dt_mpc), float)
        c_cur = np.asarray(tape.contacts[cfg.nsteps_between_mpc - 1], float)
        if (c_next != c_cur).any():
            xt = hkd.reset_map(xt, t(c_cur), t(c_next))
        x = xt.cpu().numpy()
        tape = rt.update(x)
        history.append(x.copy())
        if on_step is not None:
            on_step(it, x, tape)
    return np.stack(history), tape


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gait", default="pace")
    ap.add_argument("--ref", default=None)
    ap.add_argument("--settings-dir", default=None)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cfg, opts, source = settings(args.settings_dir)
    print(f"settings: {source}", flush=True)
    dt_mpc = cfg.nsteps_between_mpc * cfg.dt_sim
    qr = QuadReference(reference(
        args.gait, args.ref, args.out, args.device,
        max(2.0, cfg.plan_duration + args.steps * dt_mpc + 0.5)))
    qr.initialize(cfg.plan_duration)
    rt = HKDMPCRuntime(qr, cfg, opts, device=args.device)
    steps = []

    def report(it, x, tape):
        cost = float(tape.solve_info["cost"][-1])
        steps.append(dict(z=float(x[5]), cost=cost,
                          solve_ms=rt.timing["solve_ms"]))
        print(f"mpc {it:3d}: z={x[5]:.3f} cost={cost:.2f} "
              f"feas={tape.solve_info['dyn_feas']:.2e} solve "
              f"{rt.timing['solve_ms']:.1f} ms", flush=True)

    closed_loop(rt, initial_state(qr, args.device), args.steps, report)
    from cafempc_tpu_torch.viz import plots
    plots.plot_solve_convergence(rt.result.info,
                                 os.path.join(args.out, "convergence.png"))
    st = rt.plan_np.step
    plots.plot_gait_schedule(np.asarray(st.contact)[np.asarray(st.active) > 0],
                             cfg.dt_sim, os.path.join(args.out, "gait.png"))
    ok = all(Z_RANGE[0] < s["z"] < Z_RANGE[1] and np.isfinite(s["cost"])
             for s in steps)
    print(json.dumps({"hkd_mpc_demo": dict(ok=ok, steps=steps,
                                           settings=source, out=args.out)}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Barrel-roll trajectory optimization on the card (port of
`examples/barrel_roll_demo.py`).

    python -m cafempc_tpu_torch.examples.barrel_roll_demo --out DIR \\
        [--max-al 30] [--max-ddp 10] [--settings DIR] [--urdf PATH] \\
        [--device cuda|cpu]

Solves the 6-phase acrobatic whole-body TO (`problems/barrel_roll.py`,
BASELINE config 4) once at B=1 in f64 on `--device`, through the sweep
and linroll kernels on a CUDA device, and writes the trajectory in the
reference's text format (`utils/traj_logging.py`) into `--out`.  It makes
no plots (the JAX demo's `viz` plots are not ported).

Without `--urdf` the robot is the synthetic quadruped
(`models/synthetic_robot.py`); without `--settings` the settings are the
synthetic stand-in that `reference/synthetic.write_synthetic_br_settings`
writes into `--out/settings`.  Results on them are not the robot's.  The
default budget is the reference's (30 AL x 10 DDP).  Prints one JSON line
`{"barrel_roll": {...}}` last; `--device cuda` without a CUDA device
refuses to start.
"""
import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from cafempc_tpu_torch.convert import from_numpy, scenario, to_numpy
from cafempc_tpu_torch.examples.two_process_hkd_mpc import check_device
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.problems import barrel_roll as br
from cafempc_tpu_torch.reference.synthetic import write_synthetic_br_settings
from cafempc_tpu_torch.solver.hsddp import make_solver
from cafempc_tpu_torch.solver.options import load_solver_options
from cafempc_tpu_torch.utils import traj_logging

INFO_LEN = 512      # telemetry entries: the reference budget's 301 fit
MAX_RESETS = 16     # the plan's 5 reset steps, gathered


def load_robot(urdf, out, device, dtype=torch.float64):
    """The whole-body model of `urdf`, or of the synthetic quadruped
    written into `out`."""
    if urdf is None:
        urdf = synthetic_robot.write_synthetic_quadruped_urdf(out)
    return wbm.load_model(urdf, device, dtype)


def problem(setting_dir, device, dtype=torch.float64):
    """(plan_np, opts, solver inputs at B=1 on `device`) of the barrel
    roll on the settings in `setting_dir`."""
    plan_np, pen_np, Xbar0, Ubar0, _ = br.build_barrel_roll_plan(setting_dir)
    opts = load_solver_options(f"{setting_dir}/br_ddp_setting.info")
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, br.initial_state(), Xbar0, Ubar0), device, dtype)
    return plan_np, opts, (plan, type(pen)(*[a[None] for a in pen]),
                           x0[None], Xbar0[None], Ubar0[None])


def summary(s, plan_np):
    """Figures of one scenario's SolverState in numpy."""
    n = min(int(s.info.n_entries), len(s.info.cost_buf))
    active = np.asarray(plan_np.knot.active) > 0
    return dict(success=bool(s.success), iters=int(s.info.iters),
                ls_iters=int(s.info.ls_iters),
                reg_iters=int(s.info.reg_iters),
                cost_first=float(s.info.cost_buf[0]),
                cost_last=float(s.info.cost_buf[n - 1]),
                cost=float(s.cost), feas=float(s.feas),
                max_tconstr=float(s.max_tconstr),
                max_pconstr=float(s.max_pconstr),
                roll_max=float(s.traj.Xbar[active][:, 5].max()))


def device_name(device):
    """The card's name for a CUDA device, else the device string."""
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return str(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--max-al", type=int, default=30)
    ap.add_argument("--max-ddp", type=int, default=10)
    ap.add_argument("--settings", default=None)
    ap.add_argument("--urdf", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    setting_dir = args.settings or write_synthetic_br_settings(
        os.path.join(args.out, "settings"))
    model = load_robot(args.urdf, args.out, args.device)
    plan_np, opts, inputs = problem(setting_dir, args.device)
    opts = dataclasses.replace(opts, max_AL_iter=args.max_al,
                               max_DDP_iter=args.max_ddp)
    solve = make_solver(br.make_barrel_roll_fns(model), opts,
                        fused_riccati=True, parallel_line_search=False,
                        max_resets=MAX_RESETS, trim_output=False,
                        info_len=INFO_LEN)
    t0 = time.perf_counter()
    s = scenario(to_numpy(solve(*inputs)), 0)
    seconds = time.perf_counter() - t0
    traj_logging.log_trajectory_sequence(args.out, s, plan_np)
    out = dict(summary(s, plan_np), seconds=seconds,
               device=device_name(args.device),
               budget=[args.max_al, args.max_ddp], out=args.out)
    print(json.dumps({"barrel_roll": out}))
    return 0 if out["success"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

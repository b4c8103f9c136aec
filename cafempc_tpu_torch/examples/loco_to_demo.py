"""Loco_TO on the card: standalone whole-body locomotion trajectory
optimization (port of `examples/loco_to_demo.py`; reference
Locomotion/Loco_TO.cpp).

    python -m cafempc_tpu_torch.examples.loco_to_demo --out DIR \\
        [--plan-dur 1.0] [--gait flypace] [--settings DIR] \\
        [--max-al N] [--max-ddp N] [--urdf PATH] [--device cuda|cpu]

Generates the `--gait` reference with the offline generator
(`reference/generator.py`, on the card) and writes it to
`--out/quad_reference.csv`, then solves the WB-only problem
(`problems/loco_problem.py`) from the standing crouch at B=1 in f64 on
`--device` and writes the trajectory (`utils/traj_logging.py`) into
`--out`.  The plan is 1.0 s of WB knots, loco_config.info's plan_dur_wb.
With `--settings`, the reference's Locomotion/settings files give the
config and the options; without, the MHPC in-code defaults with the loco
constraint set (torque and GRF) and `SolverOptions()`.  The robot is the
synthetic quadruped unless `--urdf` names another.  Prints one JSON line
`{"loco_to": {...}}` last.
"""
import argparse
import json
import os
import time

from cafempc_tpu_torch.convert import scenario, to_numpy
from cafempc_tpu_torch.examples.barrel_roll_demo import (device_name,
                                                         load_robot)
from cafempc_tpu_torch.examples.two_process_hkd_mpc import check_device
from cafempc_tpu_torch.problems import loco_problem as lp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference import generator
from cafempc_tpu_torch.solver.options import SolverOptions
from cafempc_tpu_torch.utils import traj_logging

PLAN_DUR_WB = 1.0     # loco_config.info (Locomotion/settings)
N_STEPS_MAX = 128


def default_config(plan_dur=PLAN_DUR_WB):
    """The loco problem's config without the settings files: the MHPC
    in-code default weights, WB only, the loco constraint set."""
    return mp.MHPCConfig(plan_dur_wb=plan_dur, plan_dur_srb=0.0,
                         pcon_set="loco", n_steps_max=N_STEPS_MAX)


def write_reference(model, gait, plan_dur, path):
    """Generate the gait's reference, long enough for the plan and the
    MPC look-ahead, and write it as a quad_reference.csv."""
    ref = generator.generate_reference(gait, duration=plan_dur + 0.2,
                                       model=model)
    generator.write_quad_reference_csv(ref, path)
    return path


def summary(s, plan):
    """Figures of one scenario's SolverState in numpy."""
    X = s.traj.Xbar[to_numpy(plan.knot.active) > 0]
    n = min(int(s.info.n_entries), len(s.info.cost_buf))
    return dict(success=bool(s.success), iters=int(s.info.iters),
                ls_iters=int(s.info.ls_iters),
                cost_first=float(s.info.cost_buf[0]),
                cost_last=float(s.info.cost_buf[n - 1]),
                feas=float(s.feas), max_tconstr=float(s.max_tconstr),
                max_pconstr=float(s.max_pconstr),
                z_range=[float(X[:, 2].min()), float(X[:, 2].max())])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--plan-dur", type=float, default=PLAN_DUR_WB)
    ap.add_argument("--gait", default="flypace")
    ap.add_argument("--settings", default=None)
    ap.add_argument("--max-al", type=int, default=None)
    ap.add_argument("--max-ddp", type=int, default=None)
    ap.add_argument("--urdf", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    model = load_robot(args.urdf, args.out, args.device)
    t0 = time.perf_counter()
    csv = write_reference(model, args.gait, args.plan_dur,
                          os.path.join(args.out, "quad_reference.csv"))
    ref_s = time.perf_counter() - t0
    cfg = opts = None
    if args.settings is None:
        cfg, opts = default_config(), SolverOptions()
    t0 = time.perf_counter()
    s, plan, meta, _ = lp.solve_loco_to(
        csv, model, settings_dir=args.settings, cfg=cfg, opts=opts,
        plan_dur=args.plan_dur, max_AL_iter=args.max_al,
        max_DDP_iter=args.max_ddp, device=args.device)
    s = scenario(to_numpy(s), 0)
    seconds = time.perf_counter() - t0
    traj_logging.log_trajectory_sequence(args.out, s, to_numpy(plan))
    out = dict(summary(s, plan), wb_phases=len(meta["wb_phases"]),
               reference_seconds=ref_s, seconds=seconds,
               device=device_name(args.device), out=args.out)
    print(json.dumps({"loco_to": out}))
    return 0 if out["success"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

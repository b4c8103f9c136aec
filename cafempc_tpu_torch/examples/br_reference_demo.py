"""The MHPC cascade over a generated barrel-roll reference, on the card
(port of `examples/br_reference_demo.py`, BASELINE config 4).

    python -m cafempc_tpu_torch.examples.br_reference_demo --out DIR \\
        [--max-al 8] [--urdf PATH] [--device cuda|cpu]

Generates the in-place barrel-roll reference (`reference/acrobatic.py`,
the IK on the card) with the timing of the reference's
Reference/Data/inplace_br (stance until 0.33 s, a 0.46 s roll flight,
landing), builds the cascaded MHPC plan over the window [0.25, 0.85] s
(WB 0.6 s at 0.01, SRB 0.2 s, WB block 70, 75 steps) with the in-code
default settings, and solves it at B=1 in f64 on `--device` (8 AL
iterations, 10 gathered resets per segment: JAX
tests/test_br_reference.py:35-66).  Writes the reference CSV and the
trajectory (`utils/traj_logging.py`) into `--out`; prints the discovered
WB phases and one JSON line `{"br_reference": {...}}` last.  The
generator's own defaults put the flight at 0.5-0.95 s, where the window
would end in the air with no touchdown.  No plot and no LCM publishing.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from cafempc_tpu_torch.convert import from_numpy, scenario, to_numpy
from cafempc_tpu_torch.examples.barrel_roll_demo import (device_name,
                                                         load_robot)
from cafempc_tpu_torch.examples.two_process_hkd_mpc import check_device
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference import acrobatic, generator
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.solver.hsddp import make_solver
from cafempc_tpu_torch.solver.options import SolverOptions
from cafempc_tpu_torch.utils import traj_logging

# Reference/Data/inplace_br's timing (tests/test_br_reference.py:7-8, 96)
PRE_STANCE = 0.33
FLIGHT = 0.46
# the window (tests/test_br_reference.py:96-100)
T_START = 0.25
PLAN_DUR_WB = 0.60
PLAN_DUR_SRB = 0.2
WB_BLOCK = 70
N_STEPS_MAX = 75
MAX_RESETS = 10


def reference(model):
    """The in-place barrel roll with inplace_br's timing."""
    return acrobatic.generate_barrel_roll_reference(
        pre_stance=PRE_STANCE, flight=FLIGHT, model=model)


def problem(ref, device, dtype=torch.float64):
    """(cfg, plan_np, meta, solver inputs at B=1 on `device`) of the
    window [T_START, T_START + PLAN_DUR_WB] of `ref` with the in-code
    default settings."""
    qr = QuadReference(ref)
    qr.initialize(PLAN_DUR_WB + 0.4)
    qr.step(T_START)
    cfg = mp.MHPCConfig(plan_dur_wb=PLAN_DUR_WB, plan_dur_srb=PLAN_DUR_SRB,
                        wb_block=WB_BLOCK, n_steps_max=N_STEPS_MAX)
    plan_np, pen_np, Xbar0, Ubar0, meta = mp.build_mhpc_plan(qr, cfg)
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, wb_state_ref_at(qr, 0.0), Xbar0, Ubar0), device,
        dtype)
    return cfg, plan_np, meta, (plan, type(pen)(*[a[None] for a in pen]),
                                x0[None], Xbar0[None], Ubar0[None])


def checks(res, plan_np, meta):
    """(the discovered flight phases of 30+ all-swing steps, the armed
    touchdown AL entries, the largest WB roll angle) of one scenario's
    SolveResult in numpy."""
    flights = [p for p in meta["wb_phases"] if p[3].sum() == 0 and p[2] >= 30]
    armed = int((plan_np.knot.td_mask
                 * plan_np.knot.is_terminal[:, None]).sum())
    wb = (plan_np.knot.active > 0) & (plan_np.knot.model_id == 0)
    return flights, armed, float(res.Xbar[wb][:, 5].max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--max-al", type=int, default=8)
    ap.add_argument("--urdf", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    model = load_robot(args.urdf, args.out, args.device)
    t0 = time.perf_counter()
    ref = reference(model)
    ref_s = time.perf_counter() - t0
    generator.write_quad_reference_csv(
        ref, os.path.join(args.out, "quad_reference.csv"))
    cfg, plan_np, meta, inputs = problem(ref, args.device)
    print("phases:", [(round(a, 2), round(b, 2), h, c.tolist())
                      for a, b, h, c in meta["wb_phases"]])
    opts = SolverOptions(max_AL_iter=args.max_al)
    solve = make_solver(mp.make_mhpc_fns_segmented(cfg, model), opts,
                        fused_riccati=True, parallel_line_search=False,
                        max_resets=MAX_RESETS)
    t0 = time.perf_counter()
    res = scenario(to_numpy(solve(*inputs)), 0)
    seconds = time.perf_counter() - t0
    traj_logging.log_trajectory_sequence(args.out, res, plan_np)
    flights, armed, roll_max = checks(res, plan_np, meta)
    out = dict(success=bool(res.success), cost=float(res.cost),
               feas=float(res.feas), iters=int(res.info.iters),
               roll_max=roll_max, flight_phases=len(flights),
               td_al_armed=armed, reference_seconds=ref_s, seconds=seconds,
               device=device_name(args.device), out=args.out)
    print(json.dumps({"br_reference": out}))
    ok = out["success"] and np.isfinite(out["cost"]) and flights and armed
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Standalone locomotion trajectory optimization (Loco_TO; port of
`cafempc_tpu/problems/loco_problem.py`).

Mirror of the reference's third TO entry point
(MHPC/MHPC-Trajopt/Locomotion/LocoProblem.cpp:7-89, Loco_TO.cpp:16-82):
a WB-only multi-phase problem over a long horizon (loco_config.info:
plan_dur_wb 1.0, plan_dur_srb 0) with the reduced constraint set —
torque + GRF ReB path constraints and TD AL terminal constraints, no
joint box / minimum height — solved once offline at full iteration caps
from a standing initial pose.

Every file is an argument: the reference CSV, the settings directory
(loco_config.info, loco_cost_weights.JSON, loco_constraint_params.info,
loco_ddp_setting.info) or the config and options themselves.  The JAX
`build_loco_problem` reads the CSV and the ddp settings from its module
constants whatever settings directory it was given; the port does not.
"""
import dataclasses
import os

import numpy as np
import torch

from cafempc_tpu_torch.convert import from_numpy
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        load_quad_reference)
from cafempc_tpu_torch.solver.hsddp import make_solver
from cafempc_tpu_torch.solver.options import load_solver_options

# Loco_TO.cpp:53-55 initial condition (standing crouch)
X0_QJ = np.array([0.0, -1.0, 2.0] * 4)
X0_POS_Z = 0.2183


def load_loco_config(settings_dir, n_steps_max=128):
    """loco_config.info + loco_cost_weights.JSON +
    loco_constraint_params.info (LocoProblem::initialize_parameters)."""
    cfg = mp.load_mhpc_config(os.path.join(settings_dir, "loco_config.info"))
    cfg = mp.load_cost_weights(
        os.path.join(settings_dir, "loco_cost_weights.JSON"), cfg)
    cfg = mp.load_constraint_params(
        os.path.join(settings_dir, "loco_constraint_params.info"), cfg)
    cfg.pcon_set = "loco"
    cfg.n_steps_max = n_steps_max
    return cfg


def initial_state():
    """The standing crouch the solve starts from (Loco_TO.cpp:53-55)."""
    x0 = np.zeros(36)
    x0[2] = X0_POS_Z
    x0[6:18] = X0_QJ
    return x0


def build_loco_problem(ref_csv, model, *, settings_dir=None, cfg=None,
                       opts=None, plan_dur=None, device="cuda",
                       dtype=torch.float64):
    """Build (fns, opts, plan, pen, x0, Xbar0, Ubar0, meta, qr) for the Loco
    TO on the gait CSV `ref_csv` (urdf leg order) and the whole-body model
    `model` (at `device` and `dtype`): plan and pen as tensors on
    `device`, x0 [36], Xbar0 [N+1, 36] and Ubar0 [N, 12] unbatched.

    cfg defaults to `load_loco_config(settings_dir)` and opts to
    `settings_dir`'s loco_ddp_setting.info; plan_dur overrides
    cfg.plan_dur_wb (for fast tests)."""
    if cfg is None:
        cfg = load_loco_config(settings_dir)
    if opts is None:
        opts = load_solver_options(
            os.path.join(settings_dir, "loco_ddp_setting.info"))
    if plan_dur is not None:
        cfg = dataclasses.replace(cfg, plan_dur_wb=plan_dur)
    qr = QuadReference(load_quad_reference(ref_csv))
    qr.initialize(cfg.plan_dur_wb + 2 * cfg.dt_mpc)

    plan_np, pen_np, Xbar0, Ubar0, meta = mp.build_mhpc_plan(qr, cfg)
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, initial_state(), Xbar0, Ubar0), device, dtype)
    # WB-only problem: every step uses the WB model — single-model fns
    fns = mp.make_mhpc_fns(cfg, model, "wb")
    return fns, opts, plan, pen, x0, Xbar0, Ubar0, meta, qr


def solve_loco_to(ref_csv, model, *, settings_dir=None, cfg=None,
                  opts=None, plan_dur=None, max_AL_iter=None,
                  max_DDP_iter=None, max_resets=16, device="cuda",
                  dtype=torch.float64):
    """One-shot offline solve (Loco_TO.cpp:59-79) at B=1 through the sweep
    and linroll kernels on a CUDA device.  Arguments as
    `build_loco_problem`; max_AL_iter / max_DDP_iter override the options'
    caps.  Returns (the final SolverState with a leading batch of 1, the
    plan on `device`, meta, qr)."""
    (fns, opts, plan, pen, x0, Xb, Ub, meta, qr) = build_loco_problem(
        ref_csv, model, settings_dir=settings_dir, cfg=cfg, opts=opts,
        plan_dur=plan_dur, device=device, dtype=dtype)
    if max_AL_iter is not None:
        opts = dataclasses.replace(opts, max_AL_iter=max_AL_iter)
    if max_DDP_iter is not None:
        opts = dataclasses.replace(opts, max_DDP_iter=max_DDP_iter)
    solve = make_solver(fns, opts, fused_riccati=True,
                        parallel_line_search=False, max_resets=max_resets,
                        trim_output=False)
    s = solve(plan, type(pen)(*[a[None] for a in pen]), x0[None], Xb[None],
              Ub[None])
    return s, plan, meta, qr

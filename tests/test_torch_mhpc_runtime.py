"""The port's MHPC runtime against the JAX package's host steps, f64 on
CPU: `initialize` plus two `update`s on the synthetic quadruped and the
urdf-order synthetic bound reference at the small plan (WB 0.1 s, SRB
0.2 s, `n_steps_max=24`, `wb_block=16`), each update fed the solver's own
predicted state one MPC period ahead.  After each step:

  * the plan the runtime built equals the JAX `build_mhpc_plan` on a JAX
    `QuadReference` stepped the same way, array for array;
  * the warm start the solve began from equals the JAX
    `time_aligned_warm_start` of the previous solution;
  * the command tape equals the JAX runtime's `command_message` (step
    selection, column-major Quu / Qux / feedback, status times) given the
    same solver arrays.

The JAX `MHPCRuntime` is not compiled whole (two more ~2 min solver
compiles); its `command_message` runs on an instance that holds the port's
arrays.  The solves themselves are held to the JAX package in
test_torch_mhpc_solve.py.
"""
import types

import numpy as np
import pytest
import torch

from cafempc_tpu.problems import mhpc_problem as jmp
from cafempc_tpu.reference.quad_reference import \
    QuadReference as JaxQuadReference
from cafempc_tpu.runtime import mhpc_runtime as jrt
from cafempc_tpu.runtime import warm_start as jws
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import \
    synthetic_bound_reference_urdf
from cafempc_tpu_torch.runtime.mhpc_runtime import MHPCRuntime
from cafempc_tpu_torch.solver.options import SolverOptions

PLAN = dict(plan_dur_wb=0.1, plan_dur_srb=0.2, n_steps_max=24, wb_block=16)
N_UPDATES = 2
TAPE = ("mpc_times", "torque", "pos", "eul", "qJ", "vWorld", "eulrate",
        "qJd", "GRF", "feedback", "Qu", "Quu", "Qux", "contacts",
        "statusTimes")


def _qr(cls):
    qr = cls(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(0.4)
    return qr


def _predicted_state(plan_np, Xbar, dt_mpc):
    """The nominal state one MPC period ahead (post-reset knot on a tie)."""
    kn = plan_np.knot
    j = np.where((np.abs(kn.t - dt_mpc) < 1e-9) & (kn.is_terminal == 0))[0]
    return Xbar[j[0]]


def _jax_tape(rt, jqr, jmeta):
    """The JAX runtime's command_message on the port runtime's arrays."""
    j = object.__new__(jrt.MHPCRuntime)
    j.n_cmd_steps = rt.n_cmd_steps
    j.plan_np, j.meta, j.qr, j.mpc_time = rt.plan_np, jmeta, jqr, rt.mpc_time
    j.state = types.SimpleNamespace(traj=types.SimpleNamespace(
        **{k: rt.result[k] for k in ("Xbar", "Ubar", "Y", "K", "Qu", "Quu",
                                     "Qux")}))
    return j.command_message()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Per runtime step: (port runtime snapshot, JAX plan, JAX meta, JAX
    warm start or None, JAX tape)."""
    urdf = synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))
    qr, jqr = _qr(QuadReference), _qr(JaxQuadReference)
    rt = MHPCRuntime(qr, mp.MHPCConfig(**PLAN), SolverOptions(),
                     model=wbm.load_model(urdf, "cpu", torch.float64),
                     device="cpu")
    jcfg = jmp.MHPCConfig(**PLAN)
    out = []
    x = wb_state_ref_at(qr, 0.0)
    for i in range(N_UPDATES + 1):
        prev = None
        if i == 0:
            tape = rt.initialize(x)
        else:
            prev = (rt.plan_np, rt.mpc_time, rt.result["Xbar"],
                    rt.result["Ubar"])
            tape = rt.update(x)
            jqr.step(rt.cfg.dt_mpc)
        jplan = jmp.build_mhpc_plan(jqr, jcfg)
        warm = None
        if prev is not None:
            warm = jws.time_aligned_warm_start(
                prev[0].knot, prev[1], prev[2], prev[3], jplan[0].knot,
                rt.mpc_time, jplan[2], jplan[3])
        out.append(dict(plan=rt.plan_np, guess=rt.guess, tape=tape,
                        ok=bool(rt.result["success"]),
                        cost=float(rt.result["cost"]), jplan=jplan,
                        warm=warm, jtape=_jax_tape(rt, jqr, jplan[4])))
        x = _predicted_state(rt.plan_np, rt.result["Xbar"], rt.cfg.dt_mpc)
    return out


@pytest.mark.parametrize("i", range(N_UPDATES + 1))
def test_plan_matches_jax(steps, i):
    s = steps[i]
    assert s["ok"] and np.isfinite(s["cost"])
    for got, want in zip(s["plan"], s["jplan"][0]):    # StepData, KnotData
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("i", range(1, N_UPDATES + 1))
def test_warm_start_matches_jax(steps, i):
    s = steps[i]
    for g, w in zip(s["guess"], s["warm"]):
        np.testing.assert_array_equal(g, w)
    # the carried solution replaced the reference rows it matched
    assert not np.array_equal(s["guess"][0], s["jplan"][2])


@pytest.mark.parametrize("i", range(N_UPDATES + 1))
def test_command_tape_matches_jax(steps, i):
    s = steps[i]
    assert len(s["tape"].torque) == 8
    for f in TAPE:
        np.testing.assert_array_equal(getattr(s["tape"], f),
                                      np.asarray(getattr(s["jtape"], f)), f)

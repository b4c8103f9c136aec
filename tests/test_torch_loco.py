"""The port's locomotion trajectory optimization (`problems/loco_problem.py`)
against the JAX package, f64 on CPU.

Both read the same files, written for the test: the synthetic quadruped
URDF, a flypace reference from the port's generator (byte-equal to the
JAX writer's, test_torch_generator.py) and loco settings files with the
values the JAX package's tests/test_loco_to.py reads from the reference's
Locomotion/settings.  The JAX `build_loco_problem` reads the CSV under
`REF_ROOT` and the ddp settings under `LOCO_DIR`, and its WB functions
load `wbm.load_model()`'s default URDF: the test process points those
module attributes at the test's files (its per-knot WB path,
CAFEMPC_WB_LANE=0, as in test_torch_mhpc_solve.py).  The port takes every
file as an argument.

The short solve (plan_dur 0.2 s, 2 AL x 2 DDP, 16 gathered resets) is
held to the JAX `solve_loco_to` with the port's sweep on the JAX un-fused
sweep's exact Cholesky of Quu - 1e-9 I (as in test_torch_mhpc_solve.py):
Xbar and Ubar to 1e-8, cost to 1e-8 relative, iteration counts equal.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu.problems import loco_problem as jlp
from cafempc_tpu_torch.convert import to_numpy
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.problems import loco_problem as lp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference import generator

F64 = torch.float64
SOLVE_TOL = 1e-8


def _write_settings(d):
    """loco_config.info, loco_cost_weights.JSON, loco_constraint_params.info
    and loco_ddp_setting.info with the values test_loco_to.py checks in
    the reference's files; the rest from the MHPC in-code defaults."""
    cfg = mp._default_weights(mp.MHPCConfig())
    q = cfg.wb_q.copy()
    q[2] = 20.0
    (d / "loco_config.info").write_text(
        "config\n{\n    plan_dur_wb 1.0\n    plan_dur_srb 0.0\n"
        "    dt_mpc 0.02\n    dt_wb 0.01\n    dt_srb 0.05\n"
        "    BG_alpha 10.0\n    referenceFile flypace\n}\n")
    (d / "loco_cost_weights.JSON").write_text(json.dumps({
        "WB_Tracking_Cost": dict(
            qw_qB=list(q[0:6]), qw_qJ=list(q[6:9]), qw_vB=list(q[18:24]),
            qw_vJ=list(q[24:27]), rw=0.1, qfw_qB=list(cfg.wb_qf[0:6]),
            qfw_qJ=list(cfg.wb_qf[6:9]), qfw_vB=list(cfg.wb_qf[18:24]),
            qfw_vJ=list(cfg.wb_qf[24:27])),
        "SRB_Tracking_Cost": dict(
            qw_qB=list(cfg.srb_q[0:6]), qw_vB=list(cfg.srb_q[6:12]),
            rw=0.01, qfw_qB=list(cfg.srb_qf[0:6]),
            qfw_vB=list(cfg.srb_qf[6:12])),
        "WB_FootPlace_Reg": dict(qw_per_foot=list(cfg.qfoot_reg)),
        "Swing_Pos_Tracking": dict(qw_per_foot=list(cfg.qfoot_swing_pos)),
        "Swing_Vel_Tracking": dict(qw_per_foot=list(cfg.qfoot_swing_vel))}))
    (d / "loco_constraint_params.info").write_text(
        "GRF_ReB\n{\n    delta 0.2\n    delta_min 0.1\n    eps 0.1\n}\n"
        "Torque_ReB\n{\n    delta 0.1\n    delta_min 0.1\n    eps 0.01\n}\n"
        "TD_AL\n{\n    sigma 20.0\n    sigma_max 1e4\n    lambda 0.0\n}\n")
    (d / "loco_ddp_setting.info").write_text(
        "ddp\n{\n    max_AL_iter 30\n    max_DDP_iter 10\n}\n")
    return d


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(URDF, settings dir, reference root holding
    Reference/Data/flypace/quad_reference.csv)."""
    d = tmp_path_factory.mktemp("loco")
    urdf = synthetic_robot.write_synthetic_quadruped_urdf(str(d))
    settings = _write_settings(d)
    data = d / "ref" / "Reference" / "Data" / "flypace"
    data.mkdir(parents=True)
    ref = generator.generate_reference(
        "flypace", duration=1.2, model=wbm.load_model(urdf, "cpu", F64))
    generator.write_quad_reference_csv(ref, data / "quad_reference.csv")
    return urdf, str(settings), str(d / "ref")


@pytest.fixture(scope="module")
def model(files):
    return wbm.load_model(files[0], "cpu", F64)


@pytest.fixture(scope="module")
def jax_env(files):
    """The JAX module's file constants and its default model pointed at
    the test's files, for the module's tests."""
    urdf, settings, root = files
    real_model, real_config = jwbm.load_model, jlp.load_loco_config
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jlp, "REF_ROOT", root)
    mp_.setattr(jlp, "LOCO_DIR", settings)
    # their defaults were bound when the functions were defined
    mp_.setattr(jlp, "load_loco_config", lambda settings_dir=settings,
                n_steps_max=128: real_config(settings_dir, n_steps_max))
    mp_.setattr(jwbm, "load_model", lambda *a, **k: real_model(urdf))
    mp_.setenv("CAFEMPC_WB_LANE", "0")
    yield
    mp_.undo()


def _csv(files):
    return os.path.join(files[2], "Reference", "Data", "flypace",
                        "quad_reference.csv")


def test_loco_config_matches_jax(files):
    got = lp.load_loco_config(files[1])
    want = jlp.load_loco_config(files[1])
    for f in dataclasses.fields(got):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, f.name)
        else:
            assert x == y, f.name
    assert got.plan_dur_wb == 1.0 and got.plan_dur_srb == 0.0
    assert got.reference_file == "flypace" and got.pcon_set == "loco"
    assert got.reb["GRF"]["delta"] == 0.2
    assert got.reb["Torque"]["eps"] == 0.01
    assert got.td_al_sigma == 20.0 and got.wb_q[2] == 20.0


def test_loco_plan_constraint_set(files, model):
    """The JAX package's test_loco_plan_constraint_set on the port: the
    1.0 s WB-only plan, torque and GRF armed, joint box and min height
    not."""
    (fns, opts, plan, pen, x0, Xb, Ub, meta, qr) = lp.build_loco_problem(
        _csv(files), model, settings_dir=files[1], device="cpu")
    assert opts.max_AL_iter == 30 and opts.max_DDP_iter == 10
    reb = pen.reb_active.numpy()
    act = plan.step.active.numpy() > 0
    rst = plan.step.is_reset.numpy() > 0
    dyn = act & ~rst
    assert np.all(reb[dyn][:, 0:24] == 1.0)
    assert np.all(reb[:, 24:49] == 0.0)
    contact = plan.step.contact.numpy()
    for leg in range(4):
        np.testing.assert_array_equal(reb[dyn][:, 49 + 5 * leg],
                                      contact[dyn][:, leg])
    assert np.all(plan.step.model_id.numpy()[dyn] == 0)
    assert dyn.sum() == 100
    assert x0.shape == (36,) and Xb.shape == (129, 36)


def test_loco_problem_matches_jax(files, model, jax_env):
    """Plan, penalties, initial state and trajectory, and options equal to
    the JAX build_loco_problem's at plan_dur 0.4 s."""
    got = lp.build_loco_problem(_csv(files), model, settings_dir=files[1],
                                plan_dur=0.4, device="cpu")
    want = jlp.build_loco_problem(cfg=jlp.load_loco_config(files[1]),
                                  plan_dur=0.4)
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    for i, name in zip(range(2, 7), ("plan", "pen", "x0", "Xbar0", "Ubar0")):
        gl, wl = jax.tree.leaves(to_numpy(got[i])), jax.tree.leaves(want[i])
        assert len(gl) == len(wl), name
        for a, b in zip(gl, wl):
            np.testing.assert_array_equal(a, np.asarray(b), name)
    assert [p[:3] for p in got[7]["wb_phases"]] \
        == [p[:3] for p in want[7]["wb_phases"]]


def _exact_cholesky(Quu):
    """Cholesky factor of Quu - 1e-9 I, as the JAX un-fused sweep takes it."""
    eye = torch.eye(Quu.shape[-1], dtype=Quu.dtype)
    L, info = torch.linalg.cholesky_ex(Quu - 1e-9 * eye)
    return L, info == 0


def test_loco_solve_matches_jax(files, model, jax_env, monkeypatch):
    want = jlp.solve_loco_to(plan_dur=0.2, max_AL_iter=2, max_DDP_iter=2)[0]
    want = jax.tree.map(np.asarray, want)
    monkeypatch.setattr(sweep_mod, "cholesky_pivot_rule", _exact_cholesky)
    got, plan, meta, _ = lp.solve_loco_to(
        _csv(files), model, settings_dir=files[1], plan_dur=0.2,
        max_AL_iter=2, max_DDP_iter=2, device="cpu")
    got = to_numpy(got)
    assert got.success[0] and want.success
    for f in ("iters", "ls_iters", "reg_iters", "n_entries"):
        assert getattr(got.info, f)[0] == getattr(want.info, f), f
    np.testing.assert_allclose(got.traj.Xbar[0], want.traj.Xbar, rtol=0,
                               atol=SOLVE_TOL)
    np.testing.assert_allclose(got.traj.Ubar[0], want.traj.Ubar, rtol=0,
                               atol=SOLVE_TOL)
    np.testing.assert_allclose(got.cost[0], want.cost, rtol=SOLVE_TOL)
    assert float(got.feas[0]) < float(got.info.dyn_feas_buf[0, 0])

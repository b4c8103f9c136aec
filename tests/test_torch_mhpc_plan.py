"""The host half of the port's MHPC slice against the JAX package (numpy,
f64): the cascaded plan, array for array, at the `mhpc` bench shape
(`n_steps_max=48`, `wb_block=32`: 25 WB + 10 SRB knots) and at the
`cascade500` shape (JAX bench.py:113-147: 250 WB + 250 SRB knots,
`wb_block` and `n_steps_max` sized from the discovered phases), on the
urdf-order synthetic bound reference; the settings loaders on files
written from the in-code defaults; the foot handoff into the SRB tail;
and the urdf-order reference itself, whose WB state puts the synthetic
quadruped's feet on the reference footholds.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu.problems import mhpc_problem as jmp
from cafempc_tpu.reference import quad_reference as jqr
from cafempc_tpu.solver import options as jopts
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference import quad_reference as qr
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference, synthetic_bound_reference_urdf)
from cafempc_tpu_torch.solver import options


def _cascade500_cfg(module, quad_ref):
    """bench.py:128-135: WB 2.5 s at 0.01, SRB 5.0 s at 0.02, wb_block and
    n_steps_max from the discovered WB phases."""
    cfg = module.MHPCConfig(plan_dur_wb=2.5, dt_wb=0.01, plan_dur_srb=5.0,
                            dt_srb=0.02)
    phases = module.discover_wb_phases(quad_ref, cfg.plan_dur_wb, cfg.dt_wb)
    cfg.wb_block = sum(p[2] for p in phases) + len(phases)
    cfg.n_steps_max = cfg.wb_block + int(round(cfg.plan_dur_srb
                                               / cfg.dt_srb))
    return cfg


# (name, reference window, reference duration, config, WB / SRB knots)
SHAPES = [("mhpc", 0.75, 2.0, lambda m, q: m.MHPCConfig(), 25, 10),
          ("cascade500", 7.6, 8.0, _cascade500_cfg, 250, 250)]


@pytest.mark.parametrize("name,window,duration,make_cfg,n_wb,n_srb", SHAPES)
def test_plan_matches_jax(name, window, duration, make_cfg, n_wb, n_srb):
    ref = synthetic_bound_reference_urdf(duration=duration)
    a, b = qr.QuadReference(ref), jqr.QuadReference(ref)
    a.initialize(window)
    b.initialize(window)
    got = mp.build_mhpc_plan(a, make_cfg(mp, a))
    want = jmp.build_mhpc_plan(b, make_cfg(jmp, b))
    for g_part, w_part in zip(got[:4], want[:4]):
        g_leaves = jax.tree.leaves(tuple(g_part)) \
            if isinstance(g_part, tuple) else [g_part]
        w_leaves = jax.tree.leaves(tuple(w_part)) \
            if isinstance(w_part, tuple) else [w_part]
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    meta, jmeta = got[4], want[4]
    assert [p[:3] for p in meta["wb_phases"]] == \
        [p[:3] for p in jmeta["wb_phases"]]
    st = got[0].step
    dyn = (st.active > 0) & (st.is_reset == 0)
    assert int((dyn & (st.model_id == 0)).sum()) == n_wb
    assert int((dyn & (st.model_id == 1)).sum()) == n_srb
    assert meta["srb_horizon"] == n_srb and \
        np.nonzero(st.model_id)[0][0] == meta["wb_block"]


def _defaults_files(tmp_path):
    """Settings files written from the in-code defaults (the reference's
    MHPC/settings layout), with a few values moved off their defaults so
    that the loaders must read them."""
    cfg = mp._default_weights(mp.MHPCConfig())
    (tmp_path / "mhpc_config.info").write_text(
        "config\n{\n    plan_dur_wb 0.3\n    plan_dur_srb 0.45\n"
        "    dt_mpc 0.02\n    dt_wb 0.01\n    dt_srb 0.05\n"
        "    BG_alpha 12.0\n    referenceFile bound/quad_reference.csv\n"
        "    costFile cost_weights_regular.JSON\n"
        "    constraintParamFile constraint_params_regular.info\n}\n")
    (tmp_path / "cost.JSON").write_text(json.dumps({
        "WB_Tracking_Cost": dict(
            qw_qB=list(cfg.wb_q[0:6]), qw_qJ=list(cfg.wb_q[6:9]),
            qw_vB=list(cfg.wb_q[18:24]), qw_vJ=list(cfg.wb_q[24:27]),
            rw=0.2, qfw_qB=list(cfg.wb_qf[0:6]),
            qfw_qJ=list(cfg.wb_qf[6:9]), qfw_vB=list(cfg.wb_qf[18:24]),
            qfw_vJ=list(cfg.wb_qf[24:27])),
        "SRB_Tracking_Cost": dict(
            qw_qB=list(cfg.srb_q[0:6]), qw_vB=list(cfg.srb_q[6:12]),
            rw=0.02, qfw_qB=list(cfg.srb_qf[0:6]),
            qfw_vB=list(cfg.srb_qf[6:12])),
        "WB_FootPlace_Reg": dict(qw_per_foot=list(cfg.qfoot_reg)),
        "Swing_Pos_Tracking": dict(qw_per_foot=list(cfg.qfoot_swing_pos)),
        "Swing_Vel_Tracking": dict(qw_per_foot=[3.0, 3.0, 5.0])}))
    blocks = "".join(
        f"{k}_ReB\n{{\n" + "".join(f"    {n} {v}\n" for n, v in p.items())
        + "}\n" for k, p in cfg.reb.items() if k != "Joint")
    (tmp_path / "constraint.info").write_text(
        blocks + "TD_AL\n{\n    sigma 15.0\n    sigma_max 1e4\n"
        "    lambda 0.0\n}\n")
    (tmp_path / "ddp.info").write_text(
        "ddp\n{\n    alpha 0.2 ; shrink\n    max_DDP_iter 4\n"
        "    max_AL_iter 5\n    AL_active true\n    ReB_active 1\n"
        "    smooth_active false\n    cost_thresh 1e-4\n}\n")
    return tmp_path


def _same_config(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, f.name)
        else:
            assert x == y, f.name


def test_settings_loaders_match_jax(tmp_path):
    d = _defaults_files(tmp_path)
    got = mp.load_mhpc_config(d / "mhpc_config.info")
    want = jmp.load_mhpc_config(d / "mhpc_config.info")
    _same_config(got, want)
    assert got.plan_dur_wb == 0.3 and got.BG_alpha == 12.0
    got = mp.load_cost_weights(d / "cost.JSON", got)
    want = jmp.load_cost_weights(d / "cost.JSON", want)
    _same_config(got, want)
    assert got.wb_r[0] == 0.2 and got.qfoot_swing_vel[2] == 5.0
    got = mp.load_constraint_params(d / "constraint.info", got)
    want = jmp.load_constraint_params(d / "constraint.info", want)
    _same_config(got, want)
    assert got.td_al_sigma == 15.0


def test_solver_options_loader_matches_jax(tmp_path):
    path = _defaults_files(tmp_path) / "ddp.info"
    got = options.load_solver_options(path)
    want = jopts.load_solver_options(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.alpha, got.max_DDP_iter, got.cost_thresh) == (0.2, 4, 1e-4)
    (tmp_path / "bad.info").write_text("nothing\n")
    with pytest.raises(ValueError, match="no ddp block"):
        options.load_solver_options(tmp_path / "bad.info")


def test_urdf_order_reference_swaps_the_legs_back():
    """The urdf-order reference is the HKD-order one with left and right
    legs swapped (FR, FL, HR, HL -> FL, FR, HL, HR)."""
    hkd, urdf = (synthetic_bound_reference(duration=1.0),
                 synthetic_bound_reference_urdf(duration=1.0))
    np.testing.assert_array_equal(urdf.contact, qr.flip4(hkd.contact))
    np.testing.assert_array_equal(urdf.qJ, qr.flip12(hkd.qJ))
    np.testing.assert_array_equal(urdf.foot_placements,
                                  qr.flip12(hkd.foot_placements))
    np.testing.assert_array_equal(urdf.body_state, hkd.body_state)
    # the bound: front legs FL, FR together, hind legs HL, HR together
    np.testing.assert_array_equal(urdf.contact[:, 0], urdf.contact[:, 1])
    np.testing.assert_array_equal(urdf.contact[:, 2], urdf.contact[:, 3])


def test_foot_handoff_matches_jax(tmp_path):
    """The transition-frozen foot handoff (MHPCFootStep.h:26-57) on the
    `mhpc` plan, from a perturbed WB state at the handoff: the SRB tail's
    foot placements equal the JAX package's on the same robot, and the
    stance feet moved off the reference's."""
    urdf = synthetic_robot.write_synthetic_quadruped_urdf(str(tmp_path))
    ref = synthetic_bound_reference_urdf(duration=2.0)
    plans = []
    for qr_mod, m, model in (
            (qr, mp, wbm.load_model(urdf, "cpu", torch.float64)),
            (jqr, jmp, jwbm.load_model(urdf))):
        q = qr_mod.QuadReference(ref)
        q.initialize(0.75)
        cfg = m.MHPCConfig()
        plan_np = m.build_mhpc_plan(q, cfg)[0]
        x_tr = qr.wb_state_ref_at(q, cfg.plan_dur_wb)
        x_tr[0] += 0.05
        before = plan_np.step.pf_ref.copy()
        m.apply_transition_foot_handoff(plan_np, cfg, x_tr, model)
        plans.append(plan_np.step.pf_ref)
    np.testing.assert_allclose(plans[0], plans[1], rtol=0, atol=1e-12)
    assert np.abs(plans[0] - before).max() > 0.01
    np.testing.assert_array_equal(plans[0][:32], before[:32])


@pytest.mark.parametrize("t", [0.0, 0.1, 0.23, 0.37])
def test_wb_state_reference_puts_feet_on_footholds(tmp_path, t):
    """Forward kinematics of the synthetic quadruped at wb_state_ref_at
    puts each foot on the reference foot position in x and z (1e-3); in y
    the planar IK leaves the 0.011 m abad offset."""
    model = wbm.load_model(
        synthetic_robot.write_synthetic_quadruped_urdf(str(tmp_path)),
        "cpu", torch.float64)
    ref = qr.QuadReference(synthetic_bound_reference_urdf(duration=1.0))
    ref.initialize(0.4)
    x = torch.as_tensor(qr.wb_state_ref_at(ref, t))
    np.testing.assert_array_equal(qr.wb_state_ref_at(ref, t),
                                  jqr.wb_state_ref_at(ref, t))
    pf = wbm.foot_positions(model, x).numpy()
    want = ref.record_at_t(t)["foot_placements"].reshape(4, 3)
    assert np.abs(pf[:, [0, 2]] - want[:, [0, 2]]).max() < 1e-3
    assert np.abs(np.abs(pf[:, 1] - want[:, 1]) - 0.011).max() < 2e-3

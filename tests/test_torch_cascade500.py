"""The benchmark's `cascade500` configuration (`benchmark/configs/
cascade500.json`: the MHPC cascade at the JAX bench's 500-step horizon,
bench.py:113-147) on the port and on the benchmark's plain reference
(`benchmark/reference/plain`, which imports nothing of the port).

CPU, f64, one torch thread:
- the whole plan, built by both sides from the configuration's
  settings, is equal array for array: 26 WB phases, 250 WB steps and 26
  resets in the WB block of 276 steps, then 250 SRB steps (526 in all);
  the JAX package's `build_mhpc_plan` at the same settings and gait
  builds the same arrays, and its bench's sizing rule (bench.py:128-135)
  gives the configuration's `wb_block` and `n_steps_max`;
- the solver's gathered reset sites refuse that plan at the other
  cells' 16 resets a segment and take it at the configuration's 32;
- a B=2 solve (1 AL x 1 DDP) of a cascade cut to the same structure
  (dt_wb 0.01 over 0.4 s: 40 WB steps and 5 resets; dt_srb 0.02 over
  0.8 s: 40 SRB knots) agrees with the reference's within the
  tolerances below, and the same solve in f32 does not.  The port runs
  every kernel as its plain twin (`plain_ops=True`).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.problems import mhpc as bp
from cafempc_tpu.problems import mhpc_problem as jmp
from cafempc_tpu.reference import quad_reference as jqr
from cafempc_tpu_torch import convert
from cafempc_tpu_torch.parallel.mesh import make_batched_solver
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.solver import hsddp
from torch_port_inputs import one_torch_thread  # noqa: F401 (fixture)

B = 2
SEED = 23
# the cut cascade: 5 WB phases (4 touchdown resets and the model switch)
CUT = dict(plan_dur_wb=0.4, plan_dur_srb=0.8, wb_block=45, n_steps_max=85)
CUT_GAIT_S = 2.0
# The port takes the WB partials from the closed-form FK bundle, the
# reference by jvp directions: the same derivatives in another f64
# rounding order (measured: cost 2e-16 relative, Xbar 1.3e-14 of entries
# up to 7.4, K 9e-14 of gains up to 37).  Each tolerance leaves ~100x
# room above that and sits ~1e4x below the f32 solve's gaps (cost
# 4.7e-7 relative, Xbar 2.6e-4, K 2.4e-4).
COST_RTOL = 1e-11
TRAJ_ATOL = 1e-11
GAIN_ATOL = 1e-10


def cfg_of(**settings):
    cfg = harness.load_json(harness.HERE / "configs" / "cascade500.json")
    cfg["settings"].update(settings)
    return cfg


def plans(cfg, gait):
    """(port's, reference's) build_mhpc_plan over the configuration's
    window of `gait`."""
    ref_mp = bp.ref_mp()
    out = []
    for qr, mod in ((QuadReference(bp.port_gait(gait)), mp),
                    (bp.ref_qr.QuadReference(gait), ref_mp)):
        qr.initialize(bp.window_s(cfg))
        out.append(mod.build_mhpc_plan(qr,
                                       mod.MHPCConfig(**cfg["settings"])))
    return out


def leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


@pytest.fixture(scope="module")
def full():
    cfg = cfg_of()
    return cfg, plans(cfg, bp.make_gait(cfg, 8.0))


def test_the_full_plan_is_the_references(full):
    cfg, (port, ref) = full
    s = cfg["settings"]
    pl, _, Xbar0, Ubar0, meta = port
    st = pl.step
    wb = st.model_id[:s["wb_block"]] == 0
    assert len(meta["wb_phases"]) == 26
    assert Xbar0.shape == (s["n_steps_max"] + 1, mp.XS) == (527, 36)
    assert Ubar0.shape == (526, mp.US)
    assert wb.all() and (st.model_id[s["wb_block"]:] == 1).all()
    assert int(st.is_reset[:s["wb_block"]].sum()) == 26
    assert int(((st.is_reset == 0) & (st.model_id == 0)).sum()) == 250
    assert int(((st.model_id == 1) & (st.active > 0)).sum()) == 250
    assert int(st.is_reset[s["wb_block"]:].sum()) == 0
    got, want = leaves(port[:4]), leaves(ref[:4])
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_the_full_plan_is_the_jax_packages(full):
    """The JAX package's plan builder at the configuration's settings,
    on the same gait, and its bench's sizing of the WB block."""
    cfg, (port, _) = full
    s = cfg["settings"]
    gait = bp.make_gait(cfg, 8.0)
    qr = jqr.QuadReference(jqr.QuadReferenceData(
        **{f.name: getattr(gait, f.name) for f in dataclasses.fields(gait)}))
    qr.initialize(bp.window_s(cfg))
    phases = jmp.discover_wb_phases(qr, s["plan_dur_wb"], s["dt_wb"])
    wb_block = sum(p[2] for p in phases) + len(phases)
    assert (len(phases), wb_block) == (26, s["wb_block"])
    assert wb_block + round(s["plan_dur_srb"] / s["dt_srb"]) \
        == s["n_steps_max"]
    want = jmp.build_mhpc_plan(qr, jmp.MHPCConfig(**s))
    got, want = leaves(port[:4]), jax.tree.leaves(tuple(want[:4]))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [p[:3] for p in port[4]["wb_phases"]] == [p[:3] for p in phases]


def test_reset_sites_need_32(full):
    """The WB segment's 26 reset steps: more than the other cells' 16,
    within the configuration's 32."""
    cfg, (port, _) = full
    s = cfg["settings"]
    plan = convert.from_numpy(port[0], "cpu", torch.float64)
    fns = hsddp.SegmentedFns(counts=(s["wb_block"],
                                     s["n_steps_max"] - s["wb_block"]),
                             fns=(None, None))
    with pytest.raises(ValueError, match="26 reset steps"):
        hsddp.reset_sites(plan, 16, fns)
    sites = hsddp.reset_sites(plan, cfg["batched"]["solver"]["max_resets"],
                              fns)
    assert [int(st.valid.sum()) for st in sites] == [26, 0]


@pytest.fixture(scope="module")
def cut(one_torch_thread):
    """The cut cascade solved by the port in f64 and f32 and by the
    reference in f64, from the same start states."""
    cfg = cfg_of(**CUT)
    cfg["batched"]["opts"].update(max_AL_iter=1, max_DDP_iter=1)
    gait, models = bp.make_gait(cfg, CUT_GAIT_S), bp.make_models()
    try:
        x0 = torch.as_tensor(bp.nominal_x0(cfg, gait))[None] \
            + 0.01 * torch.as_tensor(
                np.random.default_rng(SEED).normal(size=(B, mp.XS)))
        out = {}
        for dt in (torch.float64, torch.float32):
            p = bp.program_batched(cfg, gait, "cpu", dt, B, models)
            solve = make_batched_solver(p["fns"], p["opts"], plain_ops=True,
                                        **p["solver_kw"])
            out[dt] = solve(p["plan"], p["pen"], x0.to(dt), p["Xbar0"],
                            p["Ubar0"])
        ref = bp.reference_batched(cfg, gait, "cpu", torch.float64, x0,
                                   models)
        plan = plans(cfg, gait)[0][0]
    finally:
        models.close()
    return out, ref, plan


def test_the_cut_cascade_has_the_structure(cut):
    st = cut[2].step
    assert int(st.is_reset.sum()) == 5
    assert int(((st.is_reset == 0) & (st.model_id == 0)).sum()) == 40
    assert int(((st.model_id == 1) & (st.active > 0)).sum()) == 40


def close(res, ref):
    """The tolerances above, each as (name, held)."""
    cost, _, X, K = ref
    c = res.cost.double().numpy()
    return dict(
        cost=np.all(np.abs(c - cost) <= COST_RTOL * np.abs(cost)),
        Xbar=np.all(np.abs(res.Xbar.double().numpy() - X) <= TRAJ_ATOL),
        K=np.all(np.abs(res.K.double().numpy() - K) <= GAIN_ATOL))


def test_port_matches_the_plain_reference(cut):
    out, ref, _ = cut
    res = out[torch.float64]
    cost, ok, X, K = ref
    assert ok.all() and res.success.all() and np.isfinite(cost).all()
    np.testing.assert_allclose(res.cost.numpy(), cost, rtol=COST_RTOL)
    np.testing.assert_allclose(res.Xbar.numpy(), X, rtol=0, atol=TRAJ_ATOL)
    np.testing.assert_allclose(res.K.numpy(), K, rtol=0, atol=GAIN_ATOL)


def test_the_f32_solve_fails_the_tolerances(cut):
    out, ref, _ = cut
    held = close(out[torch.float32], ref)
    assert not all(held.values()), held

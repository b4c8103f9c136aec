"""The port's HKD settings surface against the JAX package, f64 on CPU:

* `load_hkd_constraint_params` against the JAX loader on reference-format
  files (non-default values, a missing block, a missing key): equal
  `HKDConfig`s;
* `write_synthetic_hkd_settings` read back by both packages' loaders, and
  by the HKD demo's `--settings-dir`;
* `pen_to_device` and the facet helpers;
* the JAX package's CAFEMPC_HKD_AD_PARTIALS=1: a B=4, 40-step solve of
  the port's `make_hkd_fns` (the closed-form partials) against the JAX
  un-fused solve under the switch (cost 1e-8 relative, equal iteration
  counts), the port's sweep given the JAX sweep's exact
  factorization: the kernel's pivot rule differs from it by 1e-9 / d
  relative, which moves this solve's cost by ~7e-8 (see
  tests/test_torch_hkd_solve.py, which holds the port to JAX both ways);
* the scenario sweep's arcdog half: `arcdog_quad_ref` against the JAX
  tool's `_arcdog_quad_ref` with both given the synthetic quadruped's URDF
  (1e-10), and `main --arcdog-urdf` wiring the arcdog cases to a solver of
  their own (the chains' solves stubbed: a CPU MHPC solve takes a minute).
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu.parallel.mesh import make_batched_solver as jax_batched
from cafempc_tpu.problems import hkd_problem as jhp
from cafempc_tpu.solver.options import SolverOptions as JaxSolverOptions
from cafempc_tpu.solver.options import \
    load_solver_options as jax_load_solver_options
from cafempc_tpu.solver.plan import host_plan_to_device as jax_to_device
from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.examples import hkd_mpc_demo as demo
from cafempc_tpu_torch.models import hkd, synthetic_robot, wbm
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.parallel.mesh import (broadcast_batch,
                                             make_batched_solver)
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference import generator
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference, synthetic_bound_reference_urdf,
    write_synthetic_hkd_settings)
from cafempc_tpu_torch.solver.options import (SolverOptions,
                                              load_solver_options)
from cafempc_tpu_torch.tools import scenario_sweep as ss
from torch_port_inputs import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AD_ENV = "CAFEMPC_HKD_AD_PARTIALS"
_JAX_OPTIONS = ("jax_default_matmul_precision", "jax_compilation_cache_dir",
                "jax_persistent_cache_min_entry_size_bytes",
                "jax_persistent_cache_min_compile_time_secs")

# constraint_params.info texts in the reference's format: every key
# changed; the TD_AL block missing; GRF_ReB without delta_min
PARAM_FILES = {
    "non_default": "GRF_ReB\n{\n    delta 0.25\n    delta_min 0.05\n"
                   "    eps 0.3\n}\nTD_AL\n{\n    sigma 35.0\n"
                   "    sigma_max 5000.0\n    lambda 1.5\n}\n",
    "missing_block": "GRF_ReB\n{\n    delta 0.2\n    delta_min 0.02\n"
                     "    eps 0.4\n}\n",
    "missing_key": "GRF_ReB\n{\n    delta 0.3\n    eps 0.6\n}\n"
                   "TD_AL\n{\n    sigma 10.0\n    sigma_max 2e3\n"
                   "    lambda 0.5\n}\n",
}


@pytest.mark.parametrize("case", sorted(PARAM_FILES))
def test_constraint_params_loader_matches_jax(tmp_path, case):
    f = tmp_path / "constraint_params.info"
    f.write_text(PARAM_FILES[case])
    base = dict(plan_duration=1.0, n_steps_max=112, td_al_lambda=0.25)
    got = hp.load_hkd_constraint_params(str(f), hp.HKDConfig(**base))
    want = jhp.load_hkd_constraint_params(str(f), jhp.HKDConfig(**base))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got != hp.HKDConfig(**base)
    if case == "missing_block":
        assert (got.td_al_sigma, got.td_al_lambda) == (20.0, 0.25)
    if case == "missing_key":
        assert got.grf_reb_delta_min == hp.HKDConfig().grf_reb_delta_min


def test_synthetic_settings_read_back_by_both_packages(tmp_path):
    """The stand-in holds the in-code defaults, in both packages' reading;
    the demo's --settings-dir reads the same files."""
    root = write_synthetic_hkd_settings(str(tmp_path))
    d = os.path.join(root, "HKDMPC", "settings")
    cp, ddp = (os.path.join(d, n) for n in ("constraint_params.info",
                                             "ddp_setting.info"))
    cfg = hp.load_hkd_constraint_params(cp, hp.HKDConfig())
    assert cfg == hp.HKDConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jhp.load_hkd_constraint_params(cp, jhp.HKDConfig()))
    opts = load_solver_options(ddp)
    assert opts == SolverOptions()
    assert dataclasses.asdict(opts) == dataclasses.asdict(
        jax_load_solver_options(ddp))
    cfg_d, opts_d, source = demo.settings(root)
    assert (cfg_d, opts_d) == (hp.HKDConfig(), demo.OPTS)
    assert source.startswith(d)
    assert demo.settings(None)[:2] == (hp.HKDConfig(), demo.OPTS)


def test_pen_to_device_and_facets_match_jax():
    qr = QuadReference(synthetic_bound_reference(duration=1.0))
    qr.initialize(0.3)
    _, pen_np, _, _, _ = hp.build_hkd_plan(
        qr, hp.HKDConfig(plan_duration=0.3, n_steps_max=40))
    got = hp.pen_to_device(pen_np, torch.float64, "cpu")
    want = jhp.pen_to_device(pen_np, jnp.float64)
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert hp.pen_to_device(pen_np, device="cpu").reb_delta.dtype \
        == torch.float32
    np.testing.assert_array_equal(hp._np_facets(), jhp._np_facets())
    np.testing.assert_array_equal(hp._facets(device="cpu").numpy(),
                                  np.asarray(jhp._facets()))


# ---- the JAX package under CAFEMPC_HKD_AD_PARTIALS=1 -------------------

B = 4
OPTS = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
KW = dict(trim_output=True, parallel_line_search=False, max_resets=16,
          reg_floor=1e-3)


@pytest.fixture(scope="module")
def ad_problem():
    qr = QuadReference(synthetic_bound_reference(duration=1.0))
    qr.initialize(0.3)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(
        qr, hp.HKDConfig(plan_duration=0.3, n_steps_max=40))
    t = torch.float64
    body = np.zeros(12)
    body[5] = 0.2486
    qd = hkd.compute_hkd_state(
        torch.tensor(body[0:3], dtype=t), torch.tensor(body[3:6], dtype=t),
        torch.tensor([0.0, -0.8, 1.6] * 4, dtype=t),
        torch.as_tensor(meta["phases"][0][3], dtype=t))
    x0 = np.concatenate([body, qd.numpy()])[None] \
        + np.random.default_rng(11).normal(0, 0.01, (B, 24))
    assert plan_np.step.is_reset.sum() > 0
    return plan_np, pen_np, Xbar0, Ubar0, x0



def _exact_cholesky(Quu):
    """Cholesky factor of Quu - 1e-9 I, as the JAX un-fused sweep takes it."""
    eye = torch.eye(Quu.shape[-1], dtype=Quu.dtype)
    L, info = torch.linalg.cholesky_ex(Quu - 1e-9 * eye)
    return L, info == 0


def test_ad_switch_solve_matches_jax(ad_problem, monkeypatch):
    plan_np, pen_np, Xbar0, Ubar0, x0 = ad_problem
    monkeypatch.setattr(sweep_mod, "cholesky_pivot_rule", _exact_cholesky)
    fns = hp.make_hkd_fns()
    monkeypatch.setenv(AD_ENV, "1")
    jfns = jhp.make_hkd_fns()
    monkeypatch.delenv(AD_ENV)
    jsolve = jax_batched(jfns, JaxSolverOptions(max_AL_iter=2,
                                                max_DDP_iter=1),
                         fused_riccati=False, **KW)
    want = jax.tree.map(np.asarray, jsolve(
        jax_to_device(plan_np, jnp.float64),
        jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                     jhp.pen_to_device(pen_np, jnp.float64)),
        jnp.asarray(x0),
        jnp.broadcast_to(jnp.asarray(Xbar0), (B,) + Xbar0.shape),
        jnp.broadcast_to(jnp.asarray(Ubar0), (B,) + Ubar0.shape)))
    plan, pen, x0_t, Xb, Ub = from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), "cpu", torch.float64)
    got = to_numpy(make_batched_solver(fns, OPTS, fused_riccati=True, **KW)(
        plan, broadcast_batch(pen, B), x0_t, broadcast_batch(Xb, B),
        broadcast_batch(Ub, B)))
    assert got.success.all() and want.success.all()
    for f in ("iters", "ls_iters", "reg_iters"):
        np.testing.assert_array_equal(getattr(got.info, f),
                                      getattr(want.info, f))
    np.testing.assert_allclose(got.cost, want.cost, rtol=1e-8, atol=0)


# ---- the scenario sweep's arcdog half -----------------------------------

@pytest.fixture(scope="module")
def urdf(tmp_path_factory):
    return synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))


@pytest.fixture(scope="module")
def jtool():
    """The JAX tool as a module, the jax options it sets restored."""
    saved = {k: getattr(jax.config, k) for k in _JAX_OPTIONS}
    spec = importlib.util.spec_from_file_location(
        "jax_scenario_sweep", os.path.join(ROOT, "tools", "scenario_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def test_arcdog_quad_ref_matches_jax(jtool, urdf):
    """Both generate the gait on the same URDF with the same parameters;
    the reference window is set up alike."""
    got = ss.arcdog_quad_ref("pace", ss.MHPC_WINDOW,
                             wbm.load_model(urdf, "cpu", torch.float64))
    want = jtool._arcdog_quad_ref("pace", ss.MHPC_WINDOW,
                                  jwbm.load_model(urdf))
    assert (got.k_cur, got.t_cur, got.sz, got.dur) \
        == (want.k_cur, want.t_cur, want.sz, want.dur)
    assert got.tp.dt == want.tp.dt and len(got.tp) == len(want.tp)
    for f in ("qJ", "body_state", "foot_placements", "foot_velocities",
              "grf", "qJd", "torque"):
        np.testing.assert_allclose(getattr(got.tp, f), getattr(want.tp, f),
                                   rtol=0, atol=1e-10, err_msg=f)
    for f in ("contact", "status_dur", "foot_heights"):
        np.testing.assert_array_equal(getattr(got.tp, f),
                                      getattr(want.tp, f), f)
    assert np.isfinite(got.tp.qJ).all()
    assert got.tp.body_state[-1, 2] == pytest.approx(0.36)


def test_main_runs_the_arcdog_half_with_its_own_solver(urdf, tmp_path,
                                                       monkeypatch):
    """`main --config mhpc --arcdog-urdf` adds both arcdog gaits, on the
    URDF's model, to the mini-cheetah ones: the total divided over the six
    cases, one solver per robot, results under `arcdog/<gait>`.  The gait
    generator is stubbed with the synthetic bound and each chain's solves
    with a record of the call."""
    monkeypatch.setattr(generator, "generate_reference",
                        lambda gait, model, **kw: (
                            synthetic_bound_reference_urdf(duration=2.0)))
    calls = []

    def run_case_chain(solve_b, mesh, chain_steps, n_total, chunk, rng,
                       dtype, propagators, seen_bs=None, **kw):
        calls.append((solve_b, n_total, chunk, len(chain_steps),
                      len(propagators), id(seen_bs)))
        return dict(n_solves=n_total, n_success=n_total, timed_solves=0,
                    timed_seconds=0.0)
    monkeypatch.setattr(ss, "run_case_chain", run_case_chain)
    out = tmp_path / "sweep.json"
    r = ss.main(["--total", "14", "--chunk", "2", "--chain", "2",
                 "--device", "cpu", "--out", str(out), "--arcdog-urdf",
                 urdf])
    assert list(r["cases"]) == [f"mini_cheetah/{g}" for g in ss.MC_GAITS] \
        + [f"arcdog/{g}" for g in ss.ARCDOG_GAITS]
    assert "skipped" not in r and r["arcdog_urdf"] == os.path.abspath(urdf)
    assert set(r["arcdog_gaits"]) == set(ss.ARCDOG_GAITS)
    assert [c[1] for c in calls] == [3, 3, 2, 2, 2, 2]
    assert all(c[2:5] == (2, 2, 1) for c in calls)
    solvers = [c[0] for c in calls]
    assert len({id(s) for s in solvers[:4]}) == 1
    assert len({id(s) for s in solvers[4:]}) == 1
    assert solvers[0] is not solvers[4]
    assert calls[0][5] == calls[3][5] != calls[4][5] == calls[5][5]
    assert out.exists()


def test_main_without_arcdog_urdf_names_the_flag(tmp_path, monkeypatch):
    """Without the flag the arcdog cases are listed under `skipped`, naming
    it; the flag with `--config hkd` is refused before any work."""
    def no_gait(*a):
        raise AssertionError("a gait was made before the arguments were "
                             "checked")
    monkeypatch.setattr(ss, "gait_csv", no_gait)
    with pytest.raises(SystemExit):
        ss.main(["--config", "hkd", "--arcdog-urdf", "x.urdf", "--device",
                 "cpu", "--out", str(tmp_path / "s.json")])
    monkeypatch.setattr(ss, "run_case_chain", lambda *a, **k: dict(
        n_solves=0, n_success=0, timed_solves=0, timed_seconds=0.0))
    monkeypatch.setattr(ss, "gait_csv", lambda ref_dir, gait, model: (
        _bound_csv(tmp_path), False))
    skipped = ss.main(["--total", "4", "--chunk", "1", "--chain", "1",
                       "--device", "cpu", "--out",
                       str(tmp_path / "s.json")])["skipped"]
    assert set(skipped) == {f"arcdog/{g}" for g in ss.ARCDOG_GAITS}
    assert all("--arcdog-urdf" in v for v in skipped.values())


def _bound_csv(tmp_path):
    path = tmp_path / "bound.csv"
    if not path.exists():
        generator.write_quad_reference_csv(
            synthetic_bound_reference_urdf(duration=2.0), str(path))
    return str(path)

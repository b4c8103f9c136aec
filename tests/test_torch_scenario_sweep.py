"""The port's scenario sweep (`cafempc_tpu_torch/tools/scenario_sweep.py`)
against the JAX tool (`tools/scenario_sweep.py`), f64 on CPU, on the same
seeded inputs:

* `_warm_perm` equal to JAX's, except at the Ubar rows of terminal knots,
  which the port guards as `runtime/warm_start.time_aligned_warm_start`
  does (the warm start it gives equals that function's); `_apply_warm`
  exactly; `make_propagator` on the synthetic quadruped at B=3 to 1e-10;
  `_iter_stats` exactly (`run_case_chain` against the JAX tool's is
  tests/test_torch_scenario_chain.py);
* `main --config hkd` on the CPU at a tiny total into a temporary
  directory: gaits generated, the JSON with the JAX tool's fields.

The JAX tool sets jax options when it is imported (matmul precision and
the compilation cache); the fixture that loads it restores them.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.reference.synthetic import \
    synthetic_bound_reference_urdf
from cafempc_tpu_torch.runtime.warm_start import (time_aligned_warm_start,
                                                  warm_start_indices)
from cafempc_tpu_torch.solver.options import SolverOptions
from cafempc_tpu_torch.tools import scenario_sweep as ss
from torch_port_inputs import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
_JAX_OPTIONS = ("jax_default_matmul_precision", "jax_compilation_cache_dir",
                "jax_persistent_cache_min_entry_size_bytes",
                "jax_persistent_cache_min_compile_time_secs")


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


@pytest.fixture(scope="module")
def urdf(tmp_path_factory):
    return synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))


def _host_chain(window=0.75, cfg=None, n=2, shift=0):
    """n consecutive MHPC host plans dt_mpc apart on the urdf-order
    synthetic bound reference, starting `shift` MPC periods in, and their
    warm-start maps."""
    cfg = cfg or mp.MHPCConfig()
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(window)
    for _ in range(shift):
        qr.step(cfg.dt_mpc)
    plans = []
    for i in range(n):
        plans.append(mp.build_mhpc_plan(qr, cfg))
        if i + 1 < n:
            qr.step(cfg.dt_mpc)
    maps = [warm_start_indices(plans[i - 1][0].knot, (i - 1) * cfg.dt_mpc,
                               plans[i][0].knot, i * cfg.dt_mpc)
            for i in range(1, n)]
    return plans, maps, qr


def test_warm_perm_guards_terminal_ubar_rows(jtool):
    (old, new), (wmap,), _ = _host_chain()
    N = old[0].n_steps
    old_t, new_t = old[0].knot.is_terminal > 0, new[0].knot.is_terminal > 0
    got = [a.numpy() for a in ss._warm_perm(wmap, old_t, new_t, N, "cpu")]
    want = [np.asarray(a) for a in jtool._warm_perm(wmap, N + 1, N)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    src, dst = wmap
    inside = (dst < N) & (src < N)
    guarded = np.zeros(N, bool)
    guarded[dst[inside & (new_t[dst] | old_t[src])]] = True
    assert guarded.any(), "the plans map no terminal knot inside the steps"
    assert not got[3][guarded].any() and want[3][guarded].all()
    np.testing.assert_array_equal(got[2][~guarded], want[2][~guarded])
    np.testing.assert_array_equal(got[3][~guarded], want[3][~guarded])
    # the warm start it gives is time_aligned_warm_start's
    rng = np.random.default_rng(1)
    oX, oU = rng.normal(size=(N + 1, 36)), rng.normal(size=(N, 12))
    X0, U0 = new[2], new[3]
    Xb, Ub = ss._apply_warm(*[torch.as_tensor(a)[None] for a in
                              (X0, U0, oX, oU)], *map(torch.as_tensor, got))
    Xw, Uw = time_aligned_warm_start(old[0].knot, 0.0, oX, oU, new[0].knot,
                                     mp.MHPCConfig().dt_mpc, X0, U0)
    np.testing.assert_array_equal(Xb[0].numpy(), Xw)
    np.testing.assert_array_equal(Ub[0].numpy(), Uw)


def test_apply_warm_matches_jax(jtool):
    (old, new), (wmap,), _ = _host_chain()
    N = old[0].n_steps
    perms = jtool._warm_perm(wmap, N + 1, N)
    rng = np.random.default_rng(2)
    arrays = (rng.normal(size=(3, N + 1, 36)), rng.normal(size=(3, N, 12)),
              rng.normal(size=(3, N + 1, 36)), rng.normal(size=(3, N, 12)))
    want = jtool._apply_warm(*map(jnp.asarray, arrays), *perms)
    got = ss._apply_warm(*map(torch.as_tensor, arrays),
                         *[torch.as_tensor(np.asarray(p)) for p in perms])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _plan_with_reset_in_period():
    """The first MHPC host plan whose first MPC period crosses a reset
    step, so that the plant step applies an impact."""
    cfg = mp.MHPCConfig()
    for shift in range(40):
        (plan,), _, qr = _host_chain(n=1, shift=shift)
        st, t, k = plan[0].step, 0.0, 0
        while t < cfg.dt_mpc - 1e-9:
            if st.is_reset[k] > 0:
                return plan, qr
            t += float(st.dt[k])
            k += 1
    raise AssertionError("no plan crosses a reset in its first period")


def test_make_propagator_matches_jax(jtool, urdf):
    cfg = mp.MHPCConfig()
    plan, qr = _plan_with_reset_in_period()
    plan_np, Xbar0 = plan[0], plan[2]
    rng = np.random.default_rng(4)
    x = Xbar0[0][None] + rng.normal(0, 0.02, (3, 36))
    U = plan[3][None] + rng.normal(0, 0.5, (3,) + plan[3].shape)
    want = jtool.make_propagator(jwbm.load_model(urdf), cfg.BG_alpha,
                                 plan_np, cfg.dt_mpc)(jnp.asarray(x),
                                                      jnp.asarray(U))
    got = ss.make_propagator(wbm.load_model(urdf, "cpu", F64), cfg.BG_alpha,
                             plan_np, cfg.dt_mpc)(torch.as_tensor(x),
                                                  torch.as_tensor(U))
    want = np.asarray(want)
    assert not np.allclose(want, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_iter_stats_matches_jax(jtool):
    rng = np.random.default_rng(5)
    infos = [{k: rng.integers(0, 9, size=4) for k in
              ("iters", "ls_iters", "reg_iters")} for _ in range(3)]
    assert ss._iter_stats(infos) == jtool._iter_stats(infos)


def test_settings_dir_gives_the_files_under_the_tool_caps(tmp_path):
    """--settings-dir reads the reference's ddp_setting.info, the tool's
    iteration caps on top; without it the in-code defaults, named so."""
    d = tmp_path / "HKDMPC" / "settings"
    d.mkdir(parents=True)
    (d / "ddp_setting.info").write_text(
        "ddp\n{\n  alpha 0.5\n  max_AL_iter 9\n  max_DDP_iter 7\n}\n")
    opts, source = ss.hkd_settings(str(tmp_path))
    assert (opts.alpha, opts.max_AL_iter, opts.max_DDP_iter) == (0.5, 2, 1)
    assert source.startswith(str(d))
    opts, source = ss.hkd_settings()
    assert opts == SolverOptions(max_AL_iter=2, max_DDP_iter=1)
    assert source.startswith("in-code defaults")


# ------------------------------------------------------------- main
JAX_CASE_FIELDS = {"n", "n_success", "success_rate", "cost_p50", "cost_p95",
                   "dyn_feas_p50", "timed_solves", "timed_seconds",
                   "solves_per_s", "iters_mean", "iters_max",
                   "ls_iters_mean", "ls_iters_max", "reg_iters_mean",
                   "reg_iters_max"}
JAX_FIELDS = {"config", "devices", "total_requested", "chunk", "chain",
              "cases", "total_solves", "aggregate_solves_per_s",
              "overall_success_rate"}


def test_main_hkd_on_cpu_writes_the_jax_fields(tmp_path):
    out = tmp_path / "sweep.json"
    ss.main(["--config", "hkd", "--total", "4", "--chunk", "2",
             "--device", "cpu", "--out", str(out)])
    r = json.loads(out.read_text())
    assert JAX_FIELDS <= r.keys()
    assert set(r["cases"]) == {f"mini_cheetah/{g}" for g in ss.HKD_GAITS}
    for c in r["cases"].values():
        assert c.keys() == JAX_CASE_FIELDS
        assert np.isfinite(c["cost_p50"]) and c["success_rate"] == 1.0
    assert r["total_solves"] == 4 and r["overall_success_rate"] == 1.0
    assert r["aggregate_solves_per_s"] is not None
    assert all(g["generated"] for g in r["gaits"].values())
    for g in ss.HKD_GAITS:
        assert (tmp_path / "sweep_refs" / g / "quad_reference.csv").exists()
    assert r["settings"].startswith("in-code defaults")

"""The port's scenario-sweep MPC chain (`cafempc_tpu_torch/tools/
scenario_sweep.py::run_case_chain`) against the JAX tool's
(`tools/scenario_sweep.py`), f64 on CPU: the MHPC cascade at the small
plan of tests/test_torch_mhpc_solve.py (WB 0.1 s, SRB 0.2 s, 24 steps) on
the urdf-order synthetic bound reference, from 0.04 s in (so that the
plant step between the two plans crosses a touchdown), at B=2, chain 2,
1 AL x 1 DDP.  Both tools draw their scenarios from
`np.random.default_rng(0)`, warm-start the second plan from the first
solve and propagate the state through its controls; the JAX tool solves
with the JAX segmented solver (un-fused sweep, CAFEMPC_WB_LANE=0), the
port through its sweep twin, with the exact factorization (Xbar and Ubar
atol 1e-7, cost rtol 1e-9) and with the Pallas pivot rule (5e-6, 1e-4,
1e-6), the tolerances of tests/test_torch_mhpc_solve.py.  Success flags
and iteration counts are equal, and so is the tool's summary up to its
rounding.

The JAX solver's trace and compile (~2.5 min on CPU) are this file's
cost, kept apart from test_torch_scenario_sweep.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu.parallel.mesh import make_batched_solver as jax_batched
from cafempc_tpu.problems import mhpc_problem as jmp
from cafempc_tpu.solver.options import SolverOptions as JaxSolverOptions
from cafempc_tpu.solver.plan import host_plan_to_device as jax_to_device
from cafempc_tpu_torch.convert import to_numpy
from cafempc_tpu_torch.models import wbm
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.parallel.mesh import make_batched_solver
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import \
    synthetic_bound_reference_urdf
from cafempc_tpu_torch.runtime.warm_start import warm_start_indices
from cafempc_tpu_torch.solver.options import SolverOptions
from cafempc_tpu_torch.tools import scenario_sweep as ss
from test_torch_scenario_sweep import jtool, urdf  # noqa: F401 (fixtures)
from torch_port_inputs import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 2
F64 = torch.float64
PLAN = dict(plan_dur_wb=0.1, plan_dur_srb=0.2, n_steps_max=24, wb_block=16)
WINDOW = 0.4
SHIFT = 2             # MPC periods before the first plan
OPTS = dict(max_AL_iter=1, max_DDP_iter=1)
KW = dict(trim_output=True, parallel_line_search=False, max_resets=16,
          reg_floor=1e-3)


def _qr(cfg):
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(WINDOW)
    for _ in range(SHIFT):
        qr.step(cfg.dt_mpc)
    return qr


def _recording(solve, log):
    def run(*args):
        res = solve(*args)
        log.append(res)
        return res
    return run


@pytest.fixture(scope="module")
def chain_case():
    """(cfg, the two host plans, their warm-start map, x0)."""
    cfg = mp.MHPCConfig(**PLAN)
    qr = _qr(cfg)
    x0 = wb_state_ref_at(qr, 0.0)
    plans = [mp.build_mhpc_plan(qr, cfg)]
    qr.step(cfg.dt_mpc)
    plans.append(mp.build_mhpc_plan(qr, cfg))
    wmap = warm_start_indices(plans[0][0].knot, 0.0, plans[1][0].knot,
                              cfg.dt_mpc)
    return cfg, plans, wmap, x0


@pytest.fixture(scope="module")
def jax_chain(jtool, urdf, chain_case):  # noqa: F811
    """The JAX tool's chain with the JAX segmented solver, and the solve
    results it ran."""
    cfg, plans, wmap, x0 = chain_case
    mpatch = pytest.MonkeyPatch()
    mpatch.setenv("CAFEMPC_WB_LANE", "0")
    try:
        fns = jmp.make_mhpc_fns_segmented(jmp.MHPCConfig(**vars(cfg)),
                                          jwbm.load_model(urdf), urdf=urdf)
    finally:
        mpatch.undo()
    solve = jax_batched(fns, JaxSolverOptions(**OPTS), fused_riccati=False,
                        **KW)
    steps = [(jax_to_device(p[0], dtype=jnp.float64),
              jax.tree.map(lambda a: jnp.asarray(np.asarray(a),
                                                 jnp.float64), p[1]),
              x0, p[2], p[3], m) for p, m in zip(plans, (None, wmap))]
    props = [jtool.make_propagator(jwbm.load_model(urdf), cfg.BG_alpha,
                                   plans[0][0], cfg.dt_mpc)]
    log = []
    r = jtool.run_case_chain(_recording(solve, log), None, steps, B, B,
                             np.random.default_rng(0), jnp.float64, props,
                             seen_bs={B})
    return r, [jax.tree.map(np.asarray, s) for s in log]


def _exact_cholesky(Quu):
    """Cholesky factor of Quu - 1e-9 I, as the JAX un-fused sweep takes
    it."""
    eye = torch.eye(Quu.shape[-1], dtype=Quu.dtype)
    L, info = torch.linalg.cholesky_ex(Quu - 1e-9 * eye)
    return L, info == 0


@pytest.mark.parametrize("pivot,x_tol,u_tol,cost_rtol", [
    ("exact", 1e-7, 1e-7, 1e-9),
    ("pallas", 5e-6, 1e-4, 1e-6)])
def test_run_case_chain_matches_jax(urdf, chain_case, jax_chain,  # noqa
                                    monkeypatch, pivot, x_tol, u_tol,
                                    cost_rtol):
    if pivot == "exact":
        monkeypatch.setattr(sweep_mod, "cholesky_pivot_rule",
                            _exact_cholesky)
    cfg, plans, wmap, x0 = chain_case
    model = wbm.load_model(urdf, "cpu", F64)
    steps, props = ss.mhpc_chain(_qr(cfg), cfg, model, "cpu", F64, 2)
    np.testing.assert_array_equal(steps[0][2], x0)
    for (plan, *_), host in zip(steps, plans):
        np.testing.assert_array_equal(plan.step.is_reset.numpy(),
                                      host[0].step.is_reset)
    solve = make_batched_solver(mp.make_mhpc_fns_segmented(cfg, model),
                                SolverOptions(**OPTS), fused_riccati=True,
                                **KW)
    log = []
    got = ss.run_case_chain(_recording(solve, log), None, steps, B, B,
                            np.random.default_rng(0), F64, props,
                            seen_bs={B})
    want, jlog = jax_chain
    assert len(log) == len(jlog) == 2
    for g, w in zip(map(to_numpy, log), jlog):
        np.testing.assert_array_equal(g.success, w.success)
        for f in ("iters", "ls_iters", "reg_iters"):
            np.testing.assert_array_equal(getattr(g.info, f),
                                          getattr(w.info, f))
        np.testing.assert_allclose(g.Xbar, w.Xbar, rtol=0, atol=x_tol)
        np.testing.assert_allclose(g.Ubar, w.Ubar, rtol=0, atol=u_tol)
        np.testing.assert_allclose(g.cost, w.cost, rtol=cost_rtol, atol=0)
    assert got.keys() == want.keys()
    for k in got:
        if k in ("timed_seconds", "solves_per_s"):
            continue
        if isinstance(got[k], (float, list)):
            # the summary's figures are rounded to 3-5 decimals
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)
        else:
            assert got[k] == want[k], k

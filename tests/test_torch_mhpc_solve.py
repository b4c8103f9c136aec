"""The port's MHPC cascade solve as a whole against the JAX package, f64
on CPU: the segmented problem (`make_mhpc_fns_segmented`) on the synthetic
quadruped and the urdf-order synthetic bound reference, at the small plan
of the JAX package's tests/test_mhpc_segmented.py (WB 0.1 s at dt 0.01,
SRB 0.2 s at dt 0.05, `n_steps_max=24`, `wb_block=16`: 10 WB and 4 SRB
knots, 6 reset steps in the WB segment), B=2 perturbed initial states,
2 AL x 1 DDP, sequential line search, 16 gathered resets per segment, reg
floor 1e-3.  The JAX solve is `make_batched_solver(...,
fused_riccati=False)` with CAFEMPC_WB_LANE=0 (its per-knot WB path, which
the JAX package pins equal to its lane path; one compile of ~2 min).

As in test_torch_hkd_solve.py, the port is held to the JAX solve twice:
with its sweep's factorization swapped for the JAX sweep's exact Cholesky
of Quu - 1e-9 I (Xbar/Ubar atol 1e-7, cost rtol 1e-9), and as it runs,
with the Pallas kernel's pivot scaling, which differs by 1e-9 / d relative
with d ~ 2e-3 (luu = dt r = 1e-3 I plus the reg floor): measured on this
problem Xbar 2.3e-6, Ubar 4.4e-5, cost 2.6e-7 relative, held to Xbar atol
5e-6, Ubar atol 1e-4, cost rtol 1e-6.  Iteration counts are equal in both.
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
from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.parallel.mesh import (broadcast_batch,
                                             make_batched_solver)
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import \
    synthetic_bound_reference_urdf
from cafempc_tpu_torch.solver.hsddp import SolverState
from cafempc_tpu_torch.solver.options import SolverOptions

B = 2
F64 = torch.float64
PLAN = dict(plan_dur_wb=0.1, plan_dur_srb=0.2, n_steps_max=24, wb_block=16)
OPTS = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
JAX_OPTS = JaxSolverOptions(max_AL_iter=2, max_DDP_iter=1)
KW = dict(trim_output=True, parallel_line_search=False, max_resets=16,
          reg_floor=1e-3)


@pytest.fixture(scope="module")
def urdf_path(tmp_path_factory):
    return synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))


@pytest.fixture(scope="module")
def problem():
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(0.4)
    cfg = mp.MHPCConfig(**PLAN)
    plan_np, pen_np, Xbar0, Ubar0, meta = mp.build_mhpc_plan(qr, cfg)
    x0 = wb_state_ref_at(qr, 0.0)[None] \
        + np.random.default_rng(3).normal(0, 0.01, (B, mp.XS))
    return cfg, plan_np, pen_np, Xbar0, Ubar0, x0, meta


@pytest.fixture(scope="module")
def jax_result(urdf_path, problem):
    cfg, plan_np, pen_np, Xbar0, Ubar0, x0, _ = problem
    mpatch = pytest.MonkeyPatch()
    mpatch.setenv("CAFEMPC_WB_LANE", "0")
    try:
        fns = jmp.make_mhpc_fns_segmented(jmp.MHPCConfig(**vars(cfg)),
                                          jwbm.load_model(urdf_path),
                                          urdf=urdf_path)
    finally:
        mpatch.undo()
    solve = jax_batched(fns, JAX_OPTS, fused_riccati=False, **KW)

    def batch(a):
        a = jnp.asarray(np.asarray(a), jnp.float64)
        return jnp.broadcast_to(a, (B,) + a.shape)

    res = solve(jax_to_device(plan_np, dtype=jnp.float64),
                jax.tree.map(batch, pen_np), jnp.asarray(x0),
                batch(Xbar0), batch(Ubar0))
    return jax.tree.map(np.asarray, res)


def _port_solve(urdf_path, problem, trim_output=True):
    cfg, plan_np, pen_np, Xbar0, Ubar0, x0, _ = problem
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), "cpu", F64)
    fns = mp.make_mhpc_fns_segmented(cfg, wbm.load_model(urdf_path, "cpu",
                                                         F64))
    solve = make_batched_solver(fns, OPTS, fused_riccati=True, **dict(KW,
                                                  trim_output=trim_output))
    return to_numpy(solve(plan, broadcast_batch(pen, B), x0,
                          broadcast_batch(Xbar0, B),
                          broadcast_batch(Ubar0, B)))


def _exact_cholesky(Quu):
    """Cholesky factor of Quu - 1e-9 I, as the JAX un-fused sweep takes it."""
    eye = torch.eye(Quu.shape[-1], dtype=Quu.dtype)
    L, info = torch.linalg.cholesky_ex(Quu - 1e-9 * eye)
    return L, info == 0


def test_plan_has_the_cascade_layout(problem):
    """The small plan: 10 WB dynamics steps, one intra-WB reset, carry-pad
    identity resets up to the model switch at wb_block - 1, the SRB tail
    from wb_block."""
    cfg, plan_np = problem[:2]
    st = plan_np.step
    assert np.nonzero(st.is_reset)[0].tolist() == [5, 11, 12, 13, 14, 15]
    assert np.nonzero(st.model_switch)[0].tolist() == [15]
    assert np.nonzero(st.model_id)[0].tolist() == list(range(16, 20))
    assert st.active.sum() == 20 and problem[-1]["n_knots"] == 21


@pytest.mark.parametrize("pivot,x_tol,u_tol,cost_rtol", [
    ("exact", 1e-7, 1e-7, 1e-9),
    ("pallas", 5e-6, 1e-4, 1e-6)])
def test_solve_matches_jax(urdf_path, problem, jax_result, monkeypatch,
                           pivot, x_tol, u_tol, cost_rtol):
    if pivot == "exact":
        monkeypatch.setattr(sweep_mod, "cholesky_pivot_rule",
                            _exact_cholesky)
    got, want = _port_solve(urdf_path, problem), jax_result
    assert got.success.all() and want.success.all()
    np.testing.assert_array_equal(got.success, want.success)
    for f in ("iters", "ls_iters", "reg_iters", "n_entries"):
        np.testing.assert_array_equal(getattr(got.info, f),
                                      getattr(want.info, f))
    np.testing.assert_allclose(got.Xbar, want.Xbar, rtol=0, atol=x_tol)
    np.testing.assert_allclose(got.Ubar, want.Ubar, rtol=0, atol=u_tol)
    np.testing.assert_allclose(got.cost, want.cost, rtol=cost_rtol, atol=0)
    np.testing.assert_allclose(got.max_tconstr, want.max_tconstr,
                               rtol=0, atol=x_tol)


def test_untrimmed_output_is_the_solver_state(urdf_path, problem,
                                              jax_result):
    """trim_output=False returns the final SolverState, whose traj carries
    the GRF output Y of the WB steps (zero on the SRB tail) that the
    runtime's command tape reads; its trimmed fields are the SolveResult's."""
    s = _port_solve(urdf_path, problem, trim_output=False)
    assert isinstance(s, SolverState)
    np.testing.assert_allclose(s.traj.Xbar, jax_result.Xbar, rtol=0,
                               atol=5e-6)
    wb = problem[1].step.model_id == 0
    Y = s.traj.Y
    assert Y.shape == (B, 24, mp.YS)
    assert np.abs(Y[:, wb & (problem[1].step.is_reset == 0)]).max() > 1.0
    assert not Y[:, ~wb].any()

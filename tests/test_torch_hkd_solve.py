"""The port's HKD slice as a whole against the JAX package, f64 on CPU.

* The synthetic bound reference drives both packages' plan builders,
  which must agree array for array.
* A B=2 batched solve (plan 0.6 s, 72 steps, 2 AL x 1 DDP, sequential line
  search, gathered resets, reg floor 1e-3) through the port against JAX
  `make_batched_solver(..., fused_riccati=False)` (the un-fused program
  compiles in seconds on CPU; the Pallas sweep takes minutes in interpret
  mode, and kernel-level parity is covered by test_torch_sweep.py).

The JAX un-fused sweep factors Quu - 1e-9 I exactly; the Pallas kernel,
and so the port, scale the Cholesky diagonal by rsqrt(d) instead, a
relative difference of 1e-9 / d in the gains, with d ~ 2e-3 on this
problem (luu = 1e-3 I plus the reg floor).  So the port is held to the JAX
solve twice: with its sweep's factorization swapped for the exact one,
which isolates every other part of the slice (Xbar/Ubar atol 1e-7, cost
rtol 1e-9); and as it runs, at a tolerance set by that pivot difference
(Xbar atol 2e-6, Ubar atol 2e-5, cost rtol 1e-8).  Iteration counts are
equal in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.parallel.mesh import make_batched_solver as jax_batched
from cafempc_tpu.problems import hkd_problem as jhp
from cafempc_tpu.reference.quad_reference import \
    QuadReference as JaxQuadReference
from cafempc_tpu.solver.options import SolverOptions as JaxSolverOptions
from cafempc_tpu.solver.plan import host_plan_to_device as jax_to_device
from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.parallel.mesh import (broadcast_batch,
                                             make_batched_solver)
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.reference.synthetic import synthetic_bound_reference
from cafempc_tpu_torch.solver.options import SolverOptions

B = 2
OPTS = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
JAX_OPTS = JaxSolverOptions(max_AL_iter=2, max_DDP_iter=1)
KW = dict(trim_output=True, parallel_line_search=False, max_resets=16,
          reg_floor=1e-3)


def _qr(plan_duration, cls=QuadReference):
    qr = cls(synthetic_bound_reference(duration=2.0))
    qr.initialize(plan_duration)
    return qr


def _x0(contact0):
    body = np.zeros(12)
    body[5] = 0.2486
    t = torch.float64
    qd = hkd.compute_hkd_state(
        torch.tensor(body[0:3], dtype=t), torch.tensor(body[3:6], dtype=t),
        torch.tensor([0.0, -0.8, 1.6] * 4, dtype=t),
        torch.as_tensor(contact0, dtype=t))
    x0 = np.concatenate([body, qd.numpy()])
    return x0[None] + np.random.default_rng(5).normal(0, 0.01, (B, 24))


@pytest.mark.parametrize("plan_duration,n_steps", [(0.6, 72), (1.0, 112)])
def test_plan_matches_jax(plan_duration, n_steps):
    built = hp.build_hkd_plan(_qr(plan_duration), hp.HKDConfig(
        plan_duration=plan_duration, n_steps_max=n_steps))
    want = jhp.build_hkd_plan(_qr(plan_duration, JaxQuadReference),
                              jhp.HKDConfig(
        plan_duration=plan_duration, n_steps_max=n_steps))
    for got_part, want_part in zip(built[:4], want[:4]):
        got_leaves = jax.tree.leaves(tuple(got_part)) \
            if isinstance(got_part, tuple) else [got_part]
        want_leaves = jax.tree.leaves(tuple(want_part)) \
            if isinstance(want_part, tuple) else [want_part]
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert [p[:3] for p in built[4]["phases"]] == \
        [p[:3] for p in want[4]["phases"]]


def test_synthetic_reference_joint_angles_reproduce_feet():
    """The planar IK's joint angles put each foot, through the HKD model's
    forward kinematics, at the reference foot position in x and z."""
    ref = synthetic_bound_reference(duration=1.0)
    t = torch.float64
    for leg in range(4):
        pf = hkd.foot_position(
            torch.as_tensor(ref.body_state[:, 0:3], dtype=t),
            torch.as_tensor(ref.body_state[:, 3:6], dtype=t),
            torch.as_tensor(ref.qJ[:, 3 * leg:3 * leg + 3], dtype=t), leg)
        want = ref.foot_placements[:, 3 * leg:3 * leg + 3]
        assert np.abs(pf.numpy()[:, [0, 2]] - want[:, [0, 2]]).max() < 1e-3


@pytest.fixture(scope="module")
def problem():
    qr = _qr(0.6)
    cfg = hp.HKDConfig(plan_duration=0.6, n_steps_max=72)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(qr, cfg)
    return plan_np, pen_np, Xbar0, Ubar0, _x0(meta["phases"][0][3])


@pytest.fixture(scope="module")
def jax_result(problem):
    plan_np, pen_np, Xbar0, Ubar0, x0 = problem
    pen = jhp.pen_to_device(pen_np, jnp.float64)
    solve = jax_batched(jhp.make_hkd_fns(), JAX_OPTS, fused_riccati=False,
                        **KW)
    res = solve(jax_to_device(plan_np, jnp.float64),
                jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                             pen),
                jnp.asarray(x0),
                jnp.broadcast_to(jnp.asarray(Xbar0), (B,) + Xbar0.shape),
                jnp.broadcast_to(jnp.asarray(Ubar0), (B,) + Ubar0.shape))
    return jax.tree.map(np.asarray, res)


def _port_solve(problem):
    plan_np, pen_np, Xbar0, Ubar0, x0 = problem
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), "cpu", torch.float64)
    solve = make_batched_solver(hp.make_hkd_fns(), OPTS, fused_riccati=True,
                                **KW)
    return to_numpy(solve(plan, broadcast_batch(pen, B), x0,
                          broadcast_batch(Xbar0, B),
                          broadcast_batch(Ubar0, B)))


def _exact_cholesky(Quu):
    """Cholesky factor of Quu - 1e-9 I, as the JAX un-fused sweep takes it."""
    eye = torch.eye(Quu.shape[-1], dtype=Quu.dtype)
    L, info = torch.linalg.cholesky_ex(Quu - 1e-9 * eye)
    return L, info == 0


@pytest.mark.parametrize("pivot,x_tol,u_tol,cost_rtol", [
    ("exact", 1e-7, 1e-7, 1e-9),
    ("pallas", 2e-6, 2e-5, 1e-8)])
def test_solve_matches_jax(problem, jax_result, monkeypatch, pivot, x_tol,
                           u_tol, cost_rtol):
    if pivot == "exact":
        monkeypatch.setattr(sweep_mod, "cholesky_pivot_rule",
                            _exact_cholesky)
    got, want = _port_solve(problem), jax_result
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

"""The port's HKD MPC runtime against the JAX package's, f64 on CPU:
`initialize` plus two `update`s at a 0.3 s plan on the synthetic bound
reference, both runtimes fed the same states.  Command-tape controls
atol 1e-6.

The JAX runtime solves with its defaults (masked resets, parallel line
search, scan sweep with the exact Cholesky of Quu - 1e-9 I); the port with
gathered resets, sequential line search and the fused sweep, which the
JAX package pins as the same solve.  The fused sweep's pivot scaling (see
test_torch_hkd_solve.py) differs from the exact factorization by 1e-9 / d
relative, d ~ 1e-3 at the runtime's reg = 0 first attempt, which moves the
ground-reaction forces (tens of N) by up to ~1e-5; the tape is held to
1e-6 with the exact factorization swapped in, and to 5e-5 as the port
runs.
"""
import numpy as np
import pytest
import torch

from cafempc_tpu.problems import hkd_problem as jhp
from cafempc_tpu.reference.quad_reference import \
    QuadReference as JaxQuadReference
from cafempc_tpu.runtime.mpc import HKDMPCRuntime as JaxRuntime
from cafempc_tpu.solver.options import SolverOptions as JaxSolverOptions
from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.reference.synthetic import synthetic_bound_reference
from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
from cafempc_tpu_torch.solver.options import SolverOptions

PLAN = dict(plan_duration=0.3, n_steps_max=40)
N_UPDATES = 2


def _qr(cls=QuadReference):
    qr = cls(synthetic_bound_reference(duration=1.0))
    qr.initialize(PLAN["plan_duration"])
    return qr


def _x0(qr):
    body = np.zeros(12)
    body[5] = 0.2486
    t = torch.float64
    qd = hkd.compute_hkd_state(
        torch.tensor(body[0:3], dtype=t), torch.tensor(body[3:6], dtype=t),
        torch.tensor([0.0, -0.8, 1.6] * 4, dtype=t),
        torch.as_tensor(qr.contact_at_t(0.0), dtype=t))
    return np.concatenate([body, qd.numpy()])


def _predicted_state(plan_np, Xbar, dt_mpc):
    """The nominal state one MPC period ahead (post-reset knot on a tie)."""
    kn = plan_np.knot
    j = np.where((np.abs(np.asarray(kn.t) - dt_mpc) < 1e-9)
                 & (np.asarray(kn.is_terminal) == 0))[0][0]
    return np.asarray(Xbar)[j]


@pytest.fixture(scope="module")
def jax_run():
    """JAX runtime tapes and the states fed to each solve."""
    qr = _qr(JaxQuadReference)
    rt = JaxRuntime(qr, jhp.HKDConfig(**PLAN), JaxSolverOptions())
    x = _x0(qr)
    xs, tapes = [x], [rt.initialize(x)]
    for _ in range(N_UPDATES):
        x = _predicted_state(rt.plan_np, rt.state.traj.Xbar, rt.dt_mpc)
        xs.append(x)
        tapes.append(rt.update(x))
    return xs, tapes


def _exact_cholesky(Quu):
    eye = torch.eye(Quu.shape[-1], dtype=Quu.dtype)
    L, info = torch.linalg.cholesky_ex(Quu - 1e-9 * eye)
    return L, info == 0


@pytest.mark.parametrize("pivot,tol", [("exact", 1e-6), ("pallas", 5e-5)])
def test_runtime_matches_jax(jax_run, monkeypatch, pivot, tol):
    if pivot == "exact":
        monkeypatch.setattr(sweep_mod, "cholesky_pivot_rule",
                            _exact_cholesky)
    xs, want = jax_run
    rt = HKDMPCRuntime(_qr(), hp.HKDConfig(**PLAN), SolverOptions(),
                       device="cpu", dtype=torch.float64)
    got = [rt.initialize(xs[0])] + [rt.update(x) for x in xs[1:]]
    for g, w in zip(got, want):
        assert bool(rt.result.success)
        np.testing.assert_allclose(g.controls, w.controls, rtol=0, atol=tol)
        np.testing.assert_allclose(g.times, w.times, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(g.contacts, w.contacts)
        np.testing.assert_array_equal(g.status_times, w.status_times)
        np.testing.assert_allclose(g.foot_placements, w.foot_placements,
                                   rtol=0, atol=tol)
        assert g.solve_info["iters"] == w.solve_info["iters"]

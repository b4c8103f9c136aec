"""Port of the knot-batched whole-body linearization
(cafempc_tpu_torch.models.wb_lane) against the JAX package's lane form on
the synthetic quadruped, with K leading in the port and last in the JAX
module, and against the port's own per-knot rbda / wbm path, in f64 on
CPU.  Tolerances: tests/test_wb_lane.py's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import wb_lane as jwl
from cafempc_tpu_torch import convert
from cafempc_tpu_torch.models import rbda, synthetic_robot, wb_lane, wbm

F64 = torch.float64
K = 8


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _rand_states(n, seed=0):
    rng = np.random.default_rng(seed)
    q = np.zeros((n, 18))
    q[:, 0:3] = rng.normal(0, 0.3, (n, 3))
    q[:, 2] += 0.25
    q[:, 3:6] = rng.normal(0, 0.4, (n, 3))
    q[:, 6:18] = np.tile([0.0, -0.8, 1.6], 4) + rng.normal(0, 0.4, (n, 12))
    v = rng.normal(0, 1.0, (n, 18))
    u = rng.normal(0, 5.0, (n, 12))
    contact = (rng.random((n, 4)) > 0.4).astype(float)
    contact[0], contact[1] = 1.0, 0.0
    return q, v, u, contact


@pytest.fixture(scope="module")
def urdf_path(tmp_path_factory):
    return synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))


@pytest.fixture(scope="module")
def models(urdf_path):
    """(JAX lane model, port lane model) of the same file."""
    return (jwl.load_lane_model(urdf_path),
            wb_lane.load_lane_model(urdf_path, "cpu", F64))


@pytest.fixture(scope="module")
def knots():
    q, v, u, c = _rand_states(K, seed=5)
    x = np.concatenate([q, v], 1)
    tau = np.concatenate([np.zeros((K, 6)), u], 1)
    dt = np.full(K, 0.01)
    return dict(q=q, v=v, u=u, c=c, x=x, tau=tau, dt=dt)


# name -> (JAX lane function of knot-last arrays, port function of
# knot-first tensors, atol, rtol); results are compared with the JAX
# arrays' last axis moved to the front
LANE = {
    "mass_matrix_lane": (lambda m, d: jwl.mass_matrix_lane(m, d["q"]),
                         lambda m, d: wb_lane.mass_matrix_lane(m, d["q"]),
                         1e-11, 0),
    "gravity_force_lane": (
        lambda m, d: jwl.gravity_force_lane(m, d["q"]),
        lambda m, d: wb_lane.gravity_force_lane(m, d["q"]), 1e-10, 0),
    "Mv_lane": (lambda m, d: jwl.Mv_lane(m, d["q"], d["v"]),
                lambda m, d: wb_lane.Mv_lane(m, d["q"], d["v"]), 1e-10, 0),
    "bias_force_lane": (
        lambda m, d: jwl.bias_force_lane(m, d["q"], d["v"]),
        lambda m, d: wb_lane.bias_force_lane(m, d["q"], d["v"]), 1e-10, 0),
    "foot_positions_lane": (
        lambda m, d: jwl.foot_positions_lane(m, d["q"]),
        lambda m, d: wb_lane.foot_positions_lane(m, d["q"]), 1e-12, 0),
    "foot_jacobians_lane": (
        lambda m, d: jwl.foot_jacobians_lane(m, d["q"]),
        lambda m, d: wb_lane.foot_jacobians_lane(m, d["q"]), 1e-12, 0),
    "foot_velocities_lane": (
        lambda m, d: jwl.foot_velocities_lane(m, d["q"], d["v"]),
        lambda m, d: wb_lane.foot_velocities_lane(m, d["q"], d["v"]),
        1e-11, 0),
    "foot_drift_lane": (
        lambda m, d: jwl.foot_drift_lane(m, d["q"], d["v"]),
        lambda m, d: wb_lane.foot_drift_lane(m, d["q"], d["v"]), 1e-10, 0),
    "jac_lane": (
        lambda m, d: jnp.moveaxis(jwl.jac_lane(
            lambda q_: jwl.foot_velocities_lane(m, q_, d["v"]), d["q"]),
            0, -2),
        lambda m, d: wb_lane.jac_lane(
            lambda q_: wb_lane.foot_velocities_lane(m, q_, d["v"]), d["q"]),
        1e-10, 0),
    "contact_kkt_dynamics_lane": (
        lambda m, d: jwl.contact_kkt_dynamics_lane(
            m, d["q"], d["v"], d["tau"], d["c"], 10.0),
        lambda m, d: wb_lane.contact_kkt_dynamics_lane(
            m, d["q"], d["v"], d["tau"], d["c"], 10.0), 1e-8, 0),
    "contact_kkt_dynamics_partials_lane": (
        lambda m, d: jwl.contact_kkt_dynamics_partials_lane(
            m, d["q"], d["v"], d["tau"], d["c"], 10.0),
        lambda m, d: wb_lane.contact_kkt_dynamics_partials_lane(
            m, d["q"], d["v"], d["tau"], d["c"], 10.0), 1e-10, 1e-8),
    "impulse_dynamics_lane": (
        lambda m, d: jwl.impulse_dynamics_lane(m, d["q"], d["v"], d["c"]),
        lambda m, d: wb_lane.impulse_dynamics_lane(m, d["q"], d["v"],
                                                   d["c"]), 1e-8, 0),
    "impulse_dynamics_partials_lane": (
        lambda m, d: jwl.impulse_dynamics_partials_lane(m, d["q"], d["v"],
                                                        d["c"]),
        lambda m, d: wb_lane.impulse_dynamics_partials_lane(
            m, d["q"], d["v"], d["c"]), 1e-10, 1e-8),
    "wb_dynamics_lane": (
        lambda m, d: jwl.wb_dynamics_lane(m, d["x"], d["u"], d["dt"],
                                          d["c"], 10.0),
        lambda m, d: wb_lane.wb_dynamics_lane(m, d["x"], d["u"], d["dt"],
                                              d["c"], 10.0), 1e-8, 0),
    "wb_dyn_partials_lane": (
        lambda m, d: jwl.wb_dyn_partials_lane(m, d["x"], d["u"], d["dt"],
                                              d["c"], 10.0),
        lambda m, d: wb_lane.wb_dyn_partials_lane(m, d["x"], d["u"],
                                                  d["dt"], d["c"], 10.0),
        1e-10, 1e-8),
}


def _knot_first(a):
    return np.moveaxis(np.asarray(a), -1, 0)


@pytest.fixture(scope="module")
def jax_ref(models, knots):
    """Every JAX lane function of LANE on the knots (K last), run op by op:
    the lane form is vectorized over K already, and its unrolled Cholesky
    factorizations take XLA minutes to compile."""
    d = {k: jnp.asarray(a.T) for k, a in knots.items()}
    return {k: f[0](models[0], d) for k, f in LANE.items()}


def _assert_close(got, want, atol, rtol):
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = _knot_first(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(LANE))
def test_lane_matches_jax(models, knots, jax_ref, name):
    """Each lane function of the port on K knots equals the JAX lane
    function on the same knots, K moved from last to first."""
    _, fn, atol, rtol = LANE[name]
    got = fn(models[1], {k: _t(a) for k, a in knots.items()})
    _assert_close(got, jax_ref[name], atol, rtol)


def test_lane_model_from_numpy_matches_loaded(models):
    """The JAX lane model crossed with convert.lane_model_from_numpy is the
    port's model of the same file."""
    jm = jax.tree.map(np.asarray, models[0])
    got = convert.lane_model_from_numpy(jm, "cpu", F64)
    want = models[1]
    for a, b, name in zip(got, want, want._fields):
        if torch.is_tensor(b):
            assert torch.equal(a, b), name
        elif isinstance(b, np.ndarray):
            assert np.array_equal(a, b), name
        else:
            assert a == b, name


# ---- the port's lane form against its own per-knot path ---------------

def test_kinematics_and_bias_match_rbda(models):
    """Lane M, h (Newton-Euler) and foot kinematics against rbda's (AD
    identity for h), tests/test_wb_lane.py's tolerances."""
    m = models[1]
    q, v, _, _ = (_t(a) for a in _rand_states(5))
    np.testing.assert_allclose(wb_lane.mass_matrix_lane(m, q),
                               rbda.mass_matrix(m, q), rtol=0, atol=1e-11)
    np.testing.assert_allclose(wb_lane.bias_force_lane(m, q, v),
                               rbda.bias_force(m, q, v), rtol=0, atol=1e-10)
    np.testing.assert_allclose(wb_lane.Mv_lane(m, q, v),
                               rbda._mv(rbda.mass_matrix(m, q), v), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(wb_lane.foot_drift_lane(m, q, v),
                               rbda.foot_drift(m, q, v), rtol=0, atol=1e-10)


def test_dyn_partials_match_wbm(models):
    m = models[1]
    q, v, u, c = _rand_states(4, seed=2)
    x = _t(np.concatenate([q, v], 1))
    A_l, B_l, C_l, D_l = wb_lane.wb_dyn_partials_lane(
        m, x, _t(u), _t(np.full(4, 0.01)), _t(c), 10.0)
    A, B, C, D = wbm.dynamics_partials_analytic(m, x, _t(u), 0.01, _t(c),
                                                10.0)
    np.testing.assert_allclose(A_l, A, rtol=0, atol=1e-8)
    np.testing.assert_allclose(B_l, B, rtol=0, atol=1e-8)
    np.testing.assert_allclose(C_l, C, rtol=0, atol=1e-6)
    np.testing.assert_allclose(D_l, D, rtol=0, atol=1e-6)


def test_dynamics_step_matches_wbm(models):
    m = models[1]
    q, v, u, c = _rand_states(4, seed=3)
    x = _t(np.concatenate([q, v], 1))
    xn_l, grf_l = wb_lane.wb_dynamics_lane(m, x, _t(u), _t(np.full(4, 0.01)),
                                           _t(c), 10.0)
    xn, grf = wbm.dynamics(m, x, _t(u), 0.01, _t(c), 10.0)
    np.testing.assert_allclose(xn_l, xn, rtol=0, atol=1e-8)
    np.testing.assert_allclose(grf_l, grf, rtol=0, atol=1e-8)


def test_impulse_matches_rbda(models):
    m = models[1]
    q, v, _, c = (_t(a) for a in _rand_states(5, seed=4))
    vp_l, imp_l = wb_lane.impulse_dynamics_lane(m, q, v, c)
    vp, imp = rbda.impulse_dynamics(m, q, v, c)
    np.testing.assert_allclose(vp_l, vp, rtol=0, atol=1e-9)
    np.testing.assert_allclose(imp_l, imp, rtol=0, atol=1e-8)
    dq_l, dv_l = wb_lane.impulse_dynamics_partials_lane(m, q, v, c)
    dq, dv = rbda.impulse_dynamics_partials(m, q, v, c)
    np.testing.assert_allclose(dq_l, dq, rtol=0, atol=1e-8)
    np.testing.assert_allclose(dv_l, dv, rtol=0, atol=1e-8)


def test_partials_take_any_leading_dims(models):
    """[B, N] knots give the [B*N] knots' partials."""
    m = models[1]
    q, v, u, c = _rand_states(6, seed=6)
    x = _t(np.concatenate([q, v], 1))
    dt = _t(np.full(6, 0.01))
    flat = wb_lane.wb_dyn_partials_lane(m, x, _t(u), dt, _t(c), 10.0)
    grid = wb_lane.wb_dyn_partials_lane(
        m, x.reshape(2, 3, 36), _t(u).reshape(2, 3, 12), dt.reshape(2, 3),
        _t(c).reshape(2, 3, 4), 10.0)
    for f, g in zip(flat, grid):
        np.testing.assert_allclose(g.flatten(0, 1), f, rtol=0, atol=1e-12)

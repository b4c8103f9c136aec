"""Port of the whole-body model layer (cafempc_tpu_torch.models.{urdf,
rbda, wbm}) against the JAX package on one URDF, the synthetic quadruped
written for the test, and against the C++ reference's generated
kinematics derivatives (tests/fixtures/wb_kin_derivs.npz), in f64 on CPU.

Tolerances: the JAX package's own (tests/test_wbm.py, tests/test_wb_lane.py).
"""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import rbda as jrbda
from cafempc_tpu.models import urdf as jurdf
from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu_torch import convert
from cafempc_tpu_torch.models import rbda, synthetic_robot, urdf, wbm

F64 = torch.float64
TOL = 1e-10
N_STATES = 6


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.fixture(scope="module")
def urdf_path(tmp_path_factory):
    return synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))


@pytest.fixture(scope="module")
def models(urdf_path):
    """(JAX model, port model) of the same file."""
    return jwbm.load_model(urdf_path), wbm.load_model(urdf_path, "cpu", F64)


@pytest.fixture(scope="module")
def states():
    """Seeded states around the stance pose, torques and contact sets (the
    four-foot, two-foot and flight sets among them)."""
    rng = np.random.default_rng(3)
    q = np.zeros((N_STATES, 18))
    q[:, 0:3] = rng.normal(0, 0.3, (N_STATES, 3))
    q[:, 2] += 0.25
    q[:, 3:6] = rng.normal(0, 0.4, (N_STATES, 3))
    q[:, 6:] = np.tile([0.0, -0.8, 1.6], 4) + rng.normal(0, 0.4,
                                                         (N_STATES, 12))
    v = rng.normal(0, 1.0, (N_STATES, 18))
    u = rng.normal(0, 5.0, (N_STATES, 12))
    contact = (rng.random((N_STATES, 4)) > 0.4).astype(float)
    contact[0], contact[1], contact[2] = 1.0, [1, 0, 1, 0], 0.0
    c_next = np.maximum(contact, (rng.random((N_STATES, 4)) > 0.5))
    return q, v, u, contact, c_next


# name -> (JAX per-state function, port batched function, atol, rtol) of
# (model, q, v, tau, contact).  The contact and impulse dynamics and the
# impulse partials are held through WBM below, whose dynamics_continuous,
# impact and impact_partial_analytic return them unchanged.
RBDA = {
    "fk": (lambda m, q, v, t, c: jrbda.fk(m, q),
           lambda m, q, v, t, c: rbda.fk(m, q), 1e-12, 0),
    "point_jacobian": (
        lambda m, q, v, t, c: jrbda.point_jacobian(
            m, *jrbda.fk(m, q), 14, q[:3], q.dtype),
        lambda m, q, v, t, c: rbda.point_jacobian(m, *rbda.fk(m, q), 14,
                                                  q[..., :3]), 1e-12, 0),
    "mass_matrix": (lambda m, q, v, t, c: jrbda.mass_matrix(m, q),
                    lambda m, q, v, t, c: rbda.mass_matrix(m, q), 1e-11, 0),
    "gravity_force": (lambda m, q, v, t, c: jrbda.gravity_force(m, q),
                      lambda m, q, v, t, c: rbda.gravity_force(m, q),
                      1e-10, 0),
    "bias_force": (lambda m, q, v, t, c: jrbda.bias_force(m, q, v),
                   lambda m, q, v, t, c: rbda.bias_force(m, q, v), 1e-10, 0),
    "foot_kinematics": (lambda m, q, v, t, c: jrbda.foot_kinematics(m, q),
                        lambda m, q, v, t, c: rbda.foot_kinematics(m, q),
                        1e-12, 0),
    "foot_jacobians": (lambda m, q, v, t, c: jrbda.foot_jacobians(m, q),
                       lambda m, q, v, t, c: rbda.foot_jacobians(m, q),
                       1e-12, 0),
    "foot_velocities": (
        lambda m, q, v, t, c: jrbda.foot_velocities(m, q, v),
        lambda m, q, v, t, c: rbda.foot_velocities(m, q, v), 1e-11, 0),
    "foot_vel_dq": (lambda m, q, v, t, c: jrbda.foot_vel_dq(m, q, v),
                    lambda m, q, v, t, c: rbda.foot_vel_dq(m, q, v),
                    1e-10, 0),
    "foot_drift": (lambda m, q, v, t, c: jrbda.foot_drift(m, q, v),
                   lambda m, q, v, t, c: rbda.foot_drift(m, q, v), 1e-10, 0),
    # JAX side: captured inside wbm.dynamics_partials_analytic (jax_ref)
    "contact_kkt_dynamics_partials": (
        None,
        lambda m, q, v, t, c: rbda.contact_kkt_dynamics_partials(
            m, q, v, t, c, 10.0), 1e-10, 1e-8),
    "com_position": (lambda m, q, v, t, c: jrbda.com_position(m, q),
                     lambda m, q, v, t, c: rbda.com_position(m, q), 1e-12, 0),
    "centroidal_angular_momentum": (
        lambda m, q, v, t, c: jrbda.centroidal_angular_momentum(m, q, v),
        lambda m, q, v, t, c: rbda.centroidal_angular_momentum(m, q, v),
        1e-10, 0),
}


def _tau(u):
    return np.concatenate([np.zeros((u.shape[0], 6)), u], 1)


def _assert_close(got, want, atol, rtol=0.0):
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol)


def test_tree_model_equals_jax(urdf_path):
    """The port's parser gives the JAX parser's arrays, equal entry for
    entry, and the same frames and joint names."""
    want = jurdf.load_urdf_floating_base(urdf_path)
    got = urdf.load_urdf_floating_base(urdf_path)
    for f in ("parent", "jtype", "axis", "R_tree", "p_tree", "mass", "com",
              "inertia"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.joint_names == want.joint_names
    assert len(got.frames) == len(want.frames) == 4
    for (n1, d1, R1, p1), (n2, d2, R2, p2) in zip(got.frames, want.frames):
        assert (n1, d1) == (n2, d2)
        assert np.array_equal(R1, R2) and np.array_equal(p1, p2)
    assert float(got.mass.sum()) == pytest.approx(8.252, abs=1e-12)


def test_rpy_snaps_to_pi():
    """rpy entries within 1e-3 of +-pi are taken as exact +-pi, as in the
    JAX parser."""
    for rpy in ([3.1415, 0.0, -3.141592], [0.3, -0.2, 1.0]):
        got = urdf._rpy_to_rot(np.asarray(rpy))
        assert np.array_equal(got, jurdf._rpy_to_rot(np.asarray(rpy)))
    assert np.array_equal(urdf._rpy_to_rot(np.array([3.1415, 0.0, 0.0])),
                          urdf._rpy_to_rot(np.array([np.pi, 0.0, 0.0])))


@pytest.mark.parametrize("name", sorted(RBDA))
def test_rbda_matches_jax(models, states, jax_ref, name):
    """Each rbda function on a batch of states equals the JAX function
    vmapped over the same states."""
    q, v, u, c, _ = states
    _, tfn, atol, rtol = RBDA[name]
    got = tfn(models[1], *map(_t, (q, v, _tau(u), c)))
    _assert_close(got, jax_ref["rbda." + name], atol, rtol)


# name -> (JAX per-state function, port function) of (model, x, u, c, cn)
WBM = {
    "dynamics_continuous": (
        lambda m, x, u, c, cn: jwbm.dynamics_continuous(m, x, u, c),
        lambda m, x, u, c, cn: wbm.dynamics_continuous(m, x, u, c)),
    "dynamics": (lambda m, x, u, c, cn: jwbm.dynamics(m, x, u, 0.01, c),
                 lambda m, x, u, c, cn: wbm.dynamics(m, x, u, 0.01, c)),
    "dynamics_partials": (
        lambda m, x, u, c, cn: jwbm.dynamics_partials(m, x, u, 0.01, c),
        lambda m, x, u, c, cn: wbm.dynamics_partials(m, x, u, 0.01, c)),
    # JAX side: with rbda's KKT partials (jax_ref)
    "dynamics_partials_analytic": (
        None,
        lambda m, x, u, c, cn: wbm.dynamics_partials_analytic(
            m, x, u, 0.01, c)),
    "impact": (lambda m, x, u, c, cn: jwbm.impact(m, x, c, cn),
               lambda m, x, u, c, cn: wbm.impact(m, x, c, cn)),
    "impact_partial": (lambda m, x, u, c, cn: jwbm.impact_partial(m, x, c, cn),
                       lambda m, x, u, c, cn: wbm.impact_partial(m, x, c, cn)),
    "impact_partial_analytic": (
        lambda m, x, u, c, cn: jwbm.impact_partial_analytic(m, x, c, cn),
        lambda m, x, u, c, cn: wbm.impact_partial_analytic(m, x, c, cn)),
    "foot_positions": (lambda m, x, u, c, cn: jwbm.foot_positions(m, x),
                       lambda m, x, u, c, cn: wbm.foot_positions(m, x)),
    "foot_velocities": (lambda m, x, u, c, cn: jwbm.foot_velocities(m, x),
                        lambda m, x, u, c, cn: wbm.foot_velocities(m, x)),
    "foot_jacobians": (lambda m, x, u, c, cn: jwbm.foot_jacobians(m, x),
                       lambda m, x, u, c, cn: wbm.foot_jacobians(m, x)),
    "foot_vel_dq": (lambda m, x, u, c, cn: jwbm.foot_vel_dq(m, x),
                    lambda m, x, u, c, cn: wbm.foot_vel_dq(m, x)),
    "foot_heights": (lambda m, x, u, c, cn: jwbm.foot_heights(m, x),
                     lambda m, x, u, c, cn: wbm.foot_heights(m, x)),
    "centroidal_momentum": (
        lambda m, x, u, c, cn: jwbm.centroidal_momentum(m, x),
        lambda m, x, u, c, cn: wbm.centroidal_momentum(m, x)),
}


@pytest.fixture(scope="module")
def jax_ref(models, states):
    """Every JAX function of RBDA and WBM vmapped over the states, in one
    jitted program."""
    jm = models[0]
    q, v, u, c, cn = states
    x = np.concatenate([q, v], 1)

    def all_refs(q, v, tau, c, x, u, cn):
        out = {"rbda." + k: jax.vmap(lambda *a, f=f[0]: f(jm, *a))(
            q, v, tau, c) for k, f in RBDA.items() if f[0] is not None}
        out.update({"wbm." + k: jax.vmap(lambda *a, f=f[0]: f(jm, *a))(
            x, u, c, cn) for k, f in WBM.items() if f[0] is not None})
        (out["wbm.dynamics_partials_analytic"],
         out["rbda.contact_kkt_dynamics_partials"]) = jax.vmap(
            lambda *a: _analytic_and_kkt_partials(jm, *a))(x, u, c)
        return out

    return jax.jit(all_refs)(*map(jnp.asarray, (q, v, _tau(u), c, x, u,
                                                 cn)))


_JAX_KKT_PARTIALS = jrbda.contact_kkt_dynamics_partials


def _analytic_and_kkt_partials(jm, x, u, c):
    """The JAX wbm.dynamics_partials_analytic and the JAX rbda KKT partials
    it is assembled from, taken from inside it: one trace of the KKT
    partials, the costliest JAX reference, instead of two."""
    seen = []

    def capture(*args, **kwargs):
        seen.append(_JAX_KKT_PARTIALS(*args, **kwargs))
        return seen[-1]

    with mock.patch.object(jrbda, "contact_kkt_dynamics_partials", capture):
        abcd = jwbm.dynamics_partials_analytic(jm, x, u, 0.01, c, 10.0)
    return abcd, seen[0]


@pytest.mark.parametrize("name", sorted(WBM))
def test_wbm_matches_jax(models, states, jax_ref, name):
    """Dynamics, impact, both kinds of partials and the foot queries of
    wbm on a batch of states against the JAX wbm (contact dynamics and
    GRFs 1e-8; partials rtol 1e-8, atol 1e-10; kinematics 1e-10)."""
    q, v, u, c, cn = states
    got = WBM[name][1](models[1], _t(np.concatenate([q, v], 1)), *map(
        _t, (u, c, cn)))
    _assert_close(got, jax_ref["wbm." + name],
                  1e-8 if "partial" not in name else 1e-10,
                  1e-8 if "partial" in name else 0.0)


@pytest.fixture(scope="module")
def kin_fix(fixtures_dir):
    return {k: _t(a) for k, a in
            np.load(os.path.join(fixtures_dir, "wb_kin_derivs.npz")).items()}


def _foot_acc(m, q, v, qdd):
    return rbda.foot_drift(m, q, v) + rbda._mv(rbda.foot_jacobians(m, q),
                                               qdd[..., None, :])


def _jtf(m, q, F):
    """Per foot J_f^T F_f [..., 4, nd]."""
    return (rbda.foot_jacobians(m, q) * F.unflatten(-1, (4, 3))[..., None]
            ).sum(-2)


# fixture key -> the port's derivative from the fixture's inputs
KIN_DERIVS = {
    "dvdq": lambda m, d: rbda.foot_vel_dq(m, d["q"], d["v"]),
    "dadq": lambda m, d: rbda.batched_jacobian(
        lambda q_: _foot_acc(m, q_, d["v"], d["qdd"]), d["q"]),
    "dadv": lambda m, d: rbda.batched_jacobian(
        lambda v_: _foot_acc(m, d["q"], v_, d["qdd"]), d["v"]),
    "dJTFdq": lambda m, d: rbda.batched_jacobian(
        lambda q_: _jtf(m, q_, d["F"]), d["q"]),
}


@pytest.mark.parametrize("key", sorted(KIN_DERIVS))
def test_kinematics_derivatives_match_reference(models, kin_fix, key):
    """The synthetic robot through the port reproduces the reference's
    generated foot-velocity, foot-acceleration and J^T F derivatives."""
    got = KIN_DERIVS[key](models[1], kin_fix)
    assert got.shape == kin_fix[key].shape
    assert float((got - kin_fix[key]).abs().max()) < TOL


def _stance_x(rng):
    return _t(np.concatenate([[0.0, 0.0, 0.26, 0.03, -0.05, 0.02],
                              np.array([0.0, -0.8, 1.6] * 4)
                              + rng.normal(0, 0.05, 12),
                              rng.normal(0, 0.3, 18)]))


def test_free_fall(models):
    m = models[1]
    x0 = torch.zeros(36, dtype=F64)
    x0[2] = 0.35
    x0[6:18] = _t([0.0, -0.8, 1.6] * 4)
    xdot, grf = wbm.dynamics_continuous(m, x0, torch.zeros(12, dtype=F64),
                                        torch.zeros(4, dtype=F64))
    assert abs(float(xdot[20]) + 9.81) < 1e-9
    assert float(grf.abs().max()) == 0.0
    assert float(torch.cat([xdot[18:20], xdot[21:]]).abs().max()) < 1e-8


def test_baumgarte_contact_constraint(models, rng):
    m = models[1]
    q = _t(rng.uniform(-0.3, 0.3, 18))
    q[2] += 0.5
    v = _t(rng.uniform(-1, 1, 18))
    u = _t(rng.uniform(-5, 5, 12))
    c = _t([1.0, 0.0, 1.0, 1.0])
    bg = 10.0
    xdot, grf = wbm.dynamics_continuous(m, torch.cat([q, v]), u, c, bg)
    a_feet = _foot_acc(m, q, v, xdot[18:])
    vf = rbda.foot_velocities(m, q, v)
    for leg in range(4):
        if c[leg] > 0:
            assert float((a_feet[leg] + 2 * bg * vf[leg]).abs().max()) < 1e-8
        else:
            assert float(grf[3 * leg:3 * leg + 3].abs().max()) == 0


def test_impact_zeroes_new_contact_velocity(models, rng):
    m = models[1]
    q = _t(rng.uniform(-0.2, 0.2, 18))
    q[2] += 0.4
    x = torch.cat([q, _t(rng.uniform(-1, 1, 18))])
    xp, imp = wbm.impact(m, x, _t([0.0, 0.0, 1.0, 0.0]),
                         _t([1.0, 1.0, 1.0, 0.0]))
    vf_post = rbda.foot_velocities(m, xp[:18], xp[18:])
    assert float(vf_post[:2].abs().max()) < 1e-9          # impacted legs
    assert torch.equal(xp[:18], q)                        # q unchanged
    assert float(imp[9:12].abs().max()) == 0              # leg 4 untouched


def test_dynamics_partials_vs_fd(models, rng):
    m = models[1]
    q = _t(rng.uniform(-0.2, 0.2, 18))
    q[2] += 0.4
    x = torch.cat([q, _t(rng.uniform(-0.5, 0.5, 18))])
    u = _t(rng.uniform(-5, 5, 12))
    c = _t([1.0, 0.0, 0.0, 1.0])
    dt, eps = 0.01, 1e-6
    A, B, _, _ = wbm.dynamics_partials(m, x, u, dt, c)
    for i in range(0, 36, 7):
        dx = torch.zeros(36, dtype=F64)
        dx[i] = eps
        fd = (wbm.dynamics(m, x + dx, u, dt, c)[0]
              - wbm.dynamics(m, x - dx, u, dt, c)[0]) / (2 * eps)
        assert float((A[:, i] - fd).abs().max()) < 1e-5
    for i in range(0, 12, 3):
        du = torch.zeros(12, dtype=F64)
        du[i] = eps
        fd = (wbm.dynamics(m, x, u + du, dt, c)[0]
              - wbm.dynamics(m, x, u - du, dt, c)[0]) / (2 * eps)
        assert float((B[:, i] - fd).abs().max()) < 1e-5


def test_mass_matrix_properties(models, rng):
    M = rbda.mass_matrix(models[1], _t(rng.uniform(-0.5, 0.5, 18))).numpy()
    assert np.allclose(M, M.T, atol=1e-12)
    assert np.linalg.eigvalsh(M).min() > 0
    # top-left 3x3 block is total mass * I (floating-base translation)
    assert np.allclose(M[:3, :3], 8.252 * np.eye(3), atol=1e-9)


@pytest.mark.parametrize("contact", [[1, 1, 1, 1], [1, 0, 1, 0],
                                     [0, 0, 0, 0]])
def test_analytic_kkt_partials_match_jacfwd(models, contact):
    """Factored-KKT analytic partials == AD through the dynamics."""
    rng = np.random.default_rng(sum(contact) + 11)
    m = models[1]
    x, u, c = _stance_x(rng), _t(rng.normal(0, 3.0, 12)), _t(contact)
    want = wbm.dynamics_partials(m, x, u, 0.01, c, 10.0)
    got = wbm.dynamics_partials_analytic(m, x, u, 0.01, c, 10.0)
    for g, w, nm in zip(got, want, "ABCD"):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-8,
                                   atol=1e-10, err_msg=nm)


@pytest.mark.parametrize("cur,nxt", [([0, 1, 0, 1], [1, 1, 1, 1]),
                                     ([1, 1, 1, 1], [1, 1, 1, 1])])
def test_analytic_impact_partial_matches_jacfwd(models, cur, nxt):
    rng = np.random.default_rng(sum(cur) + 17)
    m = models[1]
    x = _stance_x(rng)
    np.testing.assert_allclose(
        wbm.impact_partial_analytic(m, x, _t(cur), _t(nxt)).numpy(),
        wbm.impact_partial(m, x, _t(cur), _t(nxt)).numpy(),
        rtol=1e-8, atol=1e-10)


def test_model_is_built_at_the_solve_dtype(urdf_path):
    """Every tensor leaf of a model loaded in f32 is f32 (no f64 constants
    under an f32 solve)."""
    m = wbm.load_model(urdf_path, "cpu", torch.float32)
    leaves = [f for f in m if torch.is_tensor(f)]
    assert [t.dtype for t in leaves if t.is_floating_point()] \
        == [torch.float32] * 12


def test_model_from_numpy_runs_an_edited_model(urdf_path, states):
    """One model edited in memory (a thigh's inertia and the body's mass)
    crosses to the port and gives the JAX package's dynamics."""
    jm = jax.tree.map(np.asarray, jrbda.build_model(
        jurdf.load_urdf_floating_base(urdf_path)))
    inertia = jm.inertia.copy()
    inertia[7] = np.diag([0.004, 0.003, 0.001])
    mass = jm.mass.copy()
    mass[5] = 4.1
    jm = jm._replace(inertia=inertia, mass=mass)
    tm = convert.rbda_model_from_numpy(jm, "cpu", F64)
    q, v, u, c, _ = states
    tau = _tau(u)
    want = jax.jit(jax.vmap(
        lambda *a: jrbda.contact_kkt_dynamics(jm, *a, 10.0)))(
        *map(jnp.asarray, (q, v, tau, c)))
    got = rbda.contact_kkt_dynamics(tm, *map(_t, (q, v, tau, c)), 10.0)
    _assert_close(got, want, 1e-8)
    M = rbda.mass_matrix(tm, _t(q[0]))
    assert float((M[:3, :3] - 9.052 * torch.eye(3, dtype=F64)).abs().max()) \
        < 1e-9

"""Port of the HKD model and rotations (cafempc_tpu_torch.models.hkd,
utils.rotations) against the JAX package and the golden fixtures, in f64
on CPU: every model function (the one-leg FK and Jacobian API per leg and
the AD partials included) against the JAX function vmapped over the same
states, and the foot position and Jacobian against the C++ reference's
fixture.  Tolerance atol 1e-10, the JAX model's own against the fixtures
(tests/test_hkd_model.py)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import hkd as jhkd
from cafempc_tpu.utils import rotations as jrot
from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.utils import rotations as rot

TOL = 1e-10
N_STATES = 64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def samples():
    """64 random states, controls, contacts and mode switches (numpy)."""
    r = np.random.default_rng(7)
    x = r.uniform(-1.0, 1.0, (N_STATES, 24))
    x[:, 1] = r.uniform(-0.6, 0.6, N_STATES)      # pitch away from +-pi/2
    u = r.uniform(-10.0, 10.0, (N_STATES, 24))
    dt = r.uniform(0.005, 0.02, N_STATES)
    c = (r.uniform(size=(N_STATES, 4)) > 0.5).astype(float)
    cn = (r.uniform(size=(N_STATES, 4)) > 0.5).astype(float)
    return x, u, dt, c, cn


def test_dynamics_matches_fixture(fixtures_dir):
    d = np.load(os.path.join(fixtures_dir, "hkd_dynamics.npz"))
    xn = hkd.dynamics(_t(d["x"]), _t(d["u"]), _t(d["dt"]), _t(d["ctact"]))
    assert np.abs(xn.numpy() - d["xnext"]).max() < TOL


def test_dynamics_partials_match_fixture(fixtures_dir):
    d = np.load(os.path.join(fixtures_dir, "hkd_dynamics.npz"))
    A, B = hkd.dynamics_partials(_t(d["x"]), _t(d["u"]), _t(d["dt"]),
                                 _t(d["ctact"]))
    assert np.abs(A.numpy() - d["A"]).max() < TOL
    assert np.abs(B.numpy() - d["B"]).max() < TOL


def test_foot_position_matches_fixture(fixtures_dir):
    f = np.load(os.path.join(fixtures_dir, "hkd_footpos.npz"))
    for leg in range(4):
        idx = np.where(f["leg"] == leg)[0]
        pf = hkd.foot_position(_t(f["pos"][idx]), _t(f["eul"][idx]),
                               _t(f["qleg"][idx]), leg)
        assert np.abs(pf.numpy() - f["pf"][idx]).max() < TOL


@pytest.mark.parametrize("leg", range(4))
def test_foot_jacobian_matches_fixture(fixtures_dir, leg):
    """The reference's `comp_foot_jacob_*` 3 x 18 layout, frozen from the
    C++ kernels (tests/test_hkd_model.py holds the JAX model to it)."""
    f = np.load(os.path.join(fixtures_dir, "hkd_footpos.npz"))
    idx = np.where(f["leg"] == leg)[0]
    assert len(idx) > 0
    J = hkd.foot_jacobian(_t(f["pos"][idx]), _t(f["eul"][idx]),
                          _t(f["qleg"][idx]), leg)
    assert J.shape == (len(idx), 3, 18)
    assert np.abs(J.numpy() - f["J"][idx]).max() < TOL


def _legs(fns, package):
    """The one-leg functions of `package` for each leg, on the samples'
    columns (pos 3:6, eul 0:3, the leg's own qdummy as its angles)."""
    for leg in range(4):
        q = slice(12 + 3 * leg, 15 + 3 * leg)
        fns[f"leg_fk_local_{leg}"] = \
            lambda x, u, dt, c, cn, q=q, leg=leg: package.leg_fk_local(
                x[..., q], leg)
        fns[f"leg_jacobian_local_{leg}"] = \
            lambda x, u, dt, c, cn, q=q, leg=leg: package.leg_jacobian_local(
                x[..., q], leg)
        for name in ("foot_world_jacobians", "foot_jacobian"):
            fns[f"{name}_{leg}"] = \
                lambda x, u, dt, c, cn, q=q, leg=leg, f=getattr(
                    package, name): f(x[..., 3:6], x[..., 0:3], x[..., q],
                                      leg)
    return fns


def _jax_fns():
    return _legs({
        "dynamics": lambda x, u, dt, c, cn: jhkd.dynamics(x, u, dt, c),
        "dynamics_partials":
            lambda x, u, dt, c, cn: jhkd.dynamics_partials(x, u, dt, c),
        "reset_map": lambda x, u, dt, c, cn: jhkd.reset_map(x, c, cn),
        "reset_map_partial":
            lambda x, u, dt, c, cn: jhkd.reset_map_partial(x, c, cn),
        "foot_heights": lambda x, u, dt, c, cn: jhkd.foot_heights(x),
        "touchdown_height_partials":
            lambda x, u, dt, c, cn: jhkd.touchdown_height_partials(x),
        "compute_hkd_state": lambda x, u, dt, c, cn: jhkd.compute_hkd_state(
            x[0:3], x[3:6], x[12:24], c),
        "dynamics_partials_ad":
            lambda x, u, dt, c, cn: jhkd.dynamics_partials_ad(x, u, dt, c),
        "reset_map_partial_ad":
            lambda x, u, dt, c, cn: jhkd.reset_map_partial_ad(x, c, cn),
    }, jhkd)


def _port_fns():
    return _legs({
        "dynamics": lambda x, u, dt, c, cn: hkd.dynamics(x, u, dt, c),
        "dynamics_partials":
            lambda x, u, dt, c, cn: hkd.dynamics_partials(x, u, dt, c),
        "reset_map": lambda x, u, dt, c, cn: hkd.reset_map(x, c, cn),
        "reset_map_partial":
            lambda x, u, dt, c, cn: hkd.reset_map_partial(x, c, cn),
        "foot_heights": lambda x, u, dt, c, cn: hkd.foot_heights(x),
        "touchdown_height_partials":
            lambda x, u, dt, c, cn: hkd.touchdown_height_partials(x),
        "compute_hkd_state": lambda x, u, dt, c, cn: hkd.compute_hkd_state(
            x[..., 0:3], x[..., 3:6], x[..., 12:24], c),
        "dynamics_partials_ad":
            lambda x, u, dt, c, cn: hkd.dynamics_partials_ad(x, u, dt, c),
        "reset_map_partial_ad":
            lambda x, u, dt, c, cn: hkd.reset_map_partial_ad(x, c, cn),
    }, hkd)


@pytest.mark.parametrize("name", list(_port_fns()))
def test_matches_jax_on_random_states(samples, name):
    """Each model function, batched over 64 states, equals the JAX
    function vmapped over the same states."""
    want = jax.vmap(_jax_fns()[name])(*map(jnp.asarray, samples))
    got = _port_fns()[name](*map(_t, samples))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() < TOL


@pytest.mark.parametrize("name", ["rotx", "roty", "rotz", "eul_to_rot",
                                  "euldrate_to_omega_mat",
                                  "omega_to_euldrate_mat", "skew"])
def test_rotations_match_jax(samples, name):
    eul = samples[0][:, 0:3]
    arg = eul[:, 0] if name.startswith("rot") else eul
    want = np.asarray(getattr(jrot, name)(jnp.asarray(arg)))
    got = getattr(rot, name)(_t(arg)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL


def test_partials_broadcast_over_batch_and_knots(samples):
    """[B, N] states against [N] plan data (the solver's layout) give the
    per-state results."""
    x, u, dt, c, _ = (_t(a) for a in samples)
    Xb = x.reshape(4, 16, 24)
    Ub = u.reshape(4, 16, 24)
    A, B = hkd.dynamics_partials(Xb, Ub, dt[:16], c[:16])
    A1, B1 = hkd.dynamics_partials(x[16:32], u[16:32], dt[:16], c[:16])
    assert torch.allclose(A[1], A1, rtol=0, atol=TOL)
    assert torch.allclose(B[1], B1, rtol=0, atol=TOL)


def test_ad_partials_broadcast_over_batch_and_knots(samples):
    """The AD partials in the solver's layout: [B, N] states against [N]
    plan data give the per-state results, and [B, N, 24, 24] each."""
    x, u, dt, c, cn = (_t(a) for a in samples)
    A, B = hkd.dynamics_partials_ad(x.reshape(4, 16, 24),
                                    u.reshape(4, 16, 24), dt[:16], c[:16])
    A1, B1 = hkd.dynamics_partials_ad(x[16:32], u[16:32], dt[:16], c[:16])
    assert A.shape == B.shape == (4, 16, 24, 24)
    assert torch.allclose(A[1], A1, rtol=0, atol=TOL)
    assert torch.allclose(B[1], B1, rtol=0, atol=TOL)
    P = hkd.reset_map_partial_ad(x.reshape(4, 16, 24), c[:16], cn[:16])
    assert torch.allclose(P[1], hkd.reset_map_partial_ad(
        x[16:32], c[:16], cn[:16]), rtol=0, atol=TOL)


def test_ad_partials_equal_the_closed_forms(samples):
    """The AD partials, the CAFEMPC_HKD_AD_PARTIALS=1 path, against the
    closed forms the solver takes by default (f64, 1e-12)."""
    x, u, dt, c, cn = (_t(a) for a in samples)
    for ad, cf in zip(hkd.dynamics_partials_ad(x, u, dt, c),
                      hkd.dynamics_partials(x, u, dt, c)):
        assert (ad - cf).abs().max() < 1e-12
    assert (hkd.reset_map_partial_ad(x, c, cn)
            - hkd.reset_map_partial(x, c, cn)).abs().max() < 1e-12

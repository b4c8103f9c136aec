"""The port's one whole-body linearization, the closed-form FK derivative
bundle (`wb_lane.cf_bundle`) under the factored-KKT assembly, against the
JAX package's two lane routes, its bundle (CAFEMPC_WB_CF=1 there) and its
jvp directions (its default), with the knot axis first in the port and
last in the JAX module, f64 on CPU, on the synthetic quadruped.
Tolerances: tests/test_wb_lane.py's (1e-12 for the bundle, 1e-9 for the
partials).  The JAX functions run op by op (their unrolled lane Cholesky
takes XLA minutes to compile).

The JAX package's linearization switches (CAFEMPC_WB_CF,
CAFEMPC_WB_AD_PARTIALS, CAFEMPC_HKD_AD_PARTIALS) change nothing in the
port: functions made with one set take the same route, and give the same
partials bit for bit, as functions made without it.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import wb_lane as jwl
from cafempc_tpu_torch.convert import from_numpy
from cafempc_tpu_torch.models import hkd, synthetic_robot, wb_lane
from cafempc_tpu_torch.problems import barrel_roll as br
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference_urdf, write_synthetic_br_settings)

F64 = torch.float64
K = 4
BG_ALPHA = 10.0


def _rand_states(n, seed):
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
    return dict(q=q, v=v, tau=np.concatenate([np.zeros((n, 6)), u], 1),
                c=contact)


@pytest.fixture(scope="module")
def urdf_path(tmp_path_factory):
    return synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))


@pytest.fixture(scope="module")
def models(urdf_path):
    """(JAX lane model, port model) of the same file."""
    return (jwl.load_lane_model(urdf_path),
            wb_lane.load_lane_model(urdf_path, "cpu", F64))


@pytest.fixture(scope="module")
def knots():
    d = _rand_states(K, seed=7)
    return d, {k: torch.as_tensor(a) for k, a in d.items()}


def _jax(d):
    """The knots in the JAX lane layout (knot axis last)."""
    return {k: jnp.asarray(a.T) for k, a in d.items()}


def _close(got, want, atol):
    assert tuple(got.shape) == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= atol, err


def test_cf_bundle_matches_jax(models, knots):
    """Every field of the bundle: the port's [K, ...] against the JAX
    module's [..., K] with the knot axis moved to the front."""
    jm, m = models
    d, t = knots
    got = wb_lane.cf_bundle(m, t["q"])
    want = jwl.cf_bundle(jm, _jax(d)["q"])
    assert got._fields == want._fields
    for name in got._fields:
        _close(getattr(got, name),
               np.moveaxis(np.asarray(getattr(want, name)), -1, 0), 1e-12)


def test_cf_bundle_leading_dims(models, knots):
    """Knots with two leading dims [2, K/2] give the [K] bundle's values."""
    _, m = models
    q = knots[1]["q"]
    flat = wb_lane.cf_bundle(m, q)
    for a, b in zip(flat, wb_lane.cf_bundle(m, q.reshape(2, K // 2, -1))):
        assert torch.equal(a, b.flatten(0, 1))


@pytest.mark.parametrize("which", ["contact", "impulse"])
def test_cf_partials_match_jax_and_default(models, knots, monkeypatch,
                                           which):
    """The port's contact-KKT and impulse partials against the JAX CF
    partials (CAFEMPC_WB_CF=1) and against the JAX jvp partials (its
    default, CAFEMPC_WB_CF unset), 1e-9."""
    jm, m = models
    d, t = knots
    j = _jax(d)

    def jax_partials():
        if which == "contact":
            return jwl.contact_kkt_dynamics_partials_lane(
                jm, j["q"], j["v"], j["tau"], j["c"], BG_ALPHA)
        return jwl.impulse_dynamics_partials_lane(jm, j["q"], j["v"],
                                                  j["c"])
    monkeypatch.setenv("CAFEMPC_WB_CF", "1")
    want_cf = jax_partials()
    monkeypatch.delenv("CAFEMPC_WB_CF")
    want_jvp = jax_partials()
    if which == "contact":
        got = wb_lane.contact_kkt_dynamics_partials_lane(
            m, t["q"], t["v"], t["tau"], t["c"], BG_ALPHA)
    else:
        got = wb_lane.impulse_dynamics_partials_lane(m, t["q"], t["v"],
                                                     t["c"])
    assert len(got) == len(want_cf) == len(want_jvp)
    for g, w_cf, w_jvp in zip(got, want_cf, want_jvp):
        _close(g, np.moveaxis(np.asarray(w_cf), -1, 0), 1e-9)
        _close(g, np.moveaxis(np.asarray(w_jvp), -1, 0), 1e-9)


def _mhpc_site(m, mode):
    """(fns made by make_mhpc_fns in `mode`, X, U, step data) at the 16
    WB knots of a short cascade plan."""
    qr = QuadReference(synthetic_bound_reference_urdf(duration=1.0))
    qr.initialize(0.4)
    cfg = mp.MHPCConfig(plan_dur_wb=0.1, plan_dur_srb=0.2, n_steps_max=24,
                        wb_block=16)
    plan_np, _, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, cfg)
    rng = np.random.default_rng(3)
    X = torch.as_tensor(Xbar0[None, :16] + rng.normal(0, 0.02, (1, 16, 36)))
    U = torch.as_tensor(rng.normal(0, 2.0, (1, 16, 12)))
    sd = from_numpy(plan_np, "cpu", F64).step
    sd = type(sd)(*[a[:16] for a in sd])
    return (lambda: mp.make_mhpc_fns(cfg, m, mode)), X, U, sd


def _br_site(m, tmp):
    """(fns made by make_barrel_roll_fns, X, U, step data) at the barrel
    roll's 5 reset steps (2 with a touchdown) and a step of each phase."""
    plan_np, _, Xbar0, _, _ = br.build_barrel_roll_plan(
        write_synthetic_br_settings(str(tmp / "setting")))
    st = plan_np.step
    resets = np.flatnonzero(st.is_reset > 0)
    idx = np.sort(np.r_[resets, (np.r_[0, resets + 1]
                                 + np.r_[resets, len(st.active)]) // 2])
    rng = np.random.default_rng(4)
    X = Xbar0[None, idx] + rng.normal(0, 0.05, (1, len(idx), 36))
    X[..., 18:] += rng.normal(0, 0.5, (1, len(idx), 18))
    U = torch.as_tensor(rng.normal(0, 4.0, (1, len(idx), 12)))
    sd = from_numpy(plan_np, "cpu", F64).step
    sd = type(sd)(*[a[torch.as_tensor(idx)] for a in sd])
    return (lambda: br.make_barrel_roll_fns(m)), torch.as_tensor(X), U, sd


def _hkd_site():
    """(make_hkd_fns, X, U, step data) at 3 random knots of 2
    scenarios."""
    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.uniform(-0.5, 0.5, (2, 3, 24)))
    U = torch.as_tensor(rng.uniform(-10.0, 10.0, (2, 3, 24)))
    c = (rng.random((3, 4)) > 0.5).astype(float)
    sd = types.SimpleNamespace(dt=torch.full((3,), 0.01, dtype=F64),
                               contact=torch.as_tensor(c),
                               contact_next=torch.as_tensor(1.0 - c))
    return hp.make_hkd_fns, X, U, sd


SITES = {"mhpc_wb": lambda m, tmp: _mhpc_site(m, "wb"),
         "mhpc_joint": lambda m, tmp: _mhpc_site(m, "joint"),
         "br": _br_site, "hkd": lambda m, tmp: _hkd_site()}
# (site, a JAX-package switch, its value off the JAX default)
ROUTES = {"mhpc_wb-WB_CF": ("mhpc_wb", "CAFEMPC_WB_CF", "0"),
          "mhpc_wb-WB_AD": ("mhpc_wb", "CAFEMPC_WB_AD_PARTIALS", "1"),
          "mhpc_joint-WB_AD": ("mhpc_joint", "CAFEMPC_WB_AD_PARTIALS", "1"),
          "mhpc_joint-WB_CF": ("mhpc_joint", "CAFEMPC_WB_CF", "0"),
          "br-WB_CF": ("br", "CAFEMPC_WB_CF", "0"),
          "hkd-HKD_AD": ("hkd", "CAFEMPC_HKD_AD_PARTIALS", "1")}


@pytest.mark.parametrize("case", list(ROUTES))
def test_one_linearization_route(urdf_path, tmp_path, monkeypatch, case):
    """Functions made with a JAX-package switch set take the port's one
    route, the closed-form bundle (`wb_lane.cf_bundle`; for HKD the closed
    form `hkd.dynamics_partials`), as often as functions made without it,
    and their dynamics and reset partials are the same bit for bit."""
    site, env, value = ROUTES[case]
    m = wb_lane.load_lane_model(urdf_path, "cpu", F64)
    make, X, U, sd = SITES[site](m, tmp_path)
    mod, name = (hkd, "dynamics_partials") if site == "hkd" \
        else (wb_lane, "cf_bundle")
    calls = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv(env, value)
    switched = make()
    monkeypatch.delenv(env)
    plain = make()

    def partials(fns):
        n0 = len(calls)
        out = fns.dyn_partials(X, U, sd) + (fns.reset_partial(X, sd),)
        return out, len(calls) - n0
    got, n_got = partials(switched)
    want, n_want = partials(plain)
    assert n_got == n_want > 0
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)

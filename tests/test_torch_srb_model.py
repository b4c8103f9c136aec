"""Port of the SRB model (cafempc_tpu_torch.models.srb) against the JAX
package on seeded inputs and against the C++ reference's generated SRB
dynamics (tests/fixtures/srb_dynamics.npz), in f64 on CPU.  Tolerance
1e-10, tests/test_srb_model.py's."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import srb as jsrb
from cafempc_tpu_torch.models import srb

TOL = 1e-10
N = 32


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def fix(fixtures_dir):
    return np.load(os.path.join(fixtures_dir, "srb_dynamics.npz"))


@pytest.fixture(scope="module")
def samples():
    """Seeded states (pitch away from +-pi/2), forces, feet and contacts."""
    r = np.random.default_rng(9)
    x = r.uniform(-1.0, 1.0, (N, 12))
    x[:, 4] = r.uniform(-0.6, 0.6, N)
    u = r.uniform(-60.0, 60.0, (N, 12))
    pf = r.uniform(-0.4, 0.4, (N, 12))
    c = (r.uniform(size=(N, 4)) > 0.4).astype(float)
    dt = r.uniform(0.01, 0.05, N)
    return x, u, pf, c, dt


# name -> (JAX per-sample function, port batched function) of
# (x, u, p_feet, contact, dt)
FNS = {
    "dynamics_continuous": (
        lambda x, u, pf, c, dt: jsrb.dynamics_continuous(x, u, pf, c),
        lambda x, u, pf, c, dt: srb.dynamics_continuous(x, u, pf, c)),
    "dynamics": (jsrb.dynamics, srb.dynamics),
    "dynamics_partials_continuous": (
        lambda x, u, pf, c, dt: jsrb.dynamics_partials_continuous(x, u, pf,
                                                                  c),
        lambda x, u, pf, c, dt: srb.dynamics_partials_continuous(x, u, pf,
                                                                 c)),
    "dynamics_partials": (jsrb.dynamics_partials, srb.dynamics_partials),
}


@pytest.mark.parametrize("name", sorted(FNS))
def test_matches_jax(samples, name):
    """Each function on a batch of samples (dt per sample) equals the JAX
    function vmapped over the same samples."""
    jfn, tfn = FNS[name]
    want = jax.jit(jax.vmap(jfn))(*map(jnp.asarray, samples))
    got = tfn(*map(_t, samples))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        assert np.abs(g.numpy() - np.asarray(w)).max() < TOL


@pytest.mark.parametrize("key", ["xdot", "Ac", "Bc"])
def test_matches_reference(fix, key):
    args = [_t(fix[k]) for k in ("x", "u", "pf", "ctact")]
    xdot = srb.dynamics_continuous(*args)
    Ac, Bc = srb.dynamics_partials_continuous(*args)
    got = {"xdot": xdot, "Ac": Ac, "Bc": Bc}[key]
    assert float((got - _t(fix[key])).abs().max()) < TOL


def test_discrete_step_is_forward_euler(fix):
    x, u, pf, c = (_t(fix[k][0]) for k in ("x", "u", "pf", "ctact"))
    dt = 0.05
    xn = srb.dynamics(x, u, pf, c, dt)
    assert torch.allclose(xn, x + dt * srb.dynamics_continuous(x, u, pf, c))
    A, B = srb.dynamics_partials(x, u, pf, c, dt)
    Ac, Bc = srb.dynamics_partials_continuous(x, u, pf, c)
    assert torch.allclose(A, torch.eye(12, dtype=A.dtype) + dt * Ac,
                          rtol=0, atol=TOL)
    assert torch.allclose(B, dt * Bc, rtol=0, atol=TOL)


def test_f32_inputs_stay_f32(fix):
    """Mass and inertia follow the input's dtype: f32 in, f32 out, near
    the f64 result."""
    args64 = [_t(fix[k]) for k in ("x", "u", "pf", "ctact")]
    A32, B32 = srb.dynamics_partials(*[a.float() for a in args64], 0.02)
    A64, B64 = srb.dynamics_partials(*args64, 0.02)
    assert A32.dtype == B32.dtype == torch.float32
    assert float((A32.double() - A64).abs().max()) < 1e-4
    assert float((B32.double() - B64).abs().max()) < 1e-4

"""Port of the ReB / AL penalty math (cafempc_tpu_torch.solver.penalty)
against the JAX package on the same seeded inputs, f64 on CPU, atol 1e-12.
The JAX functions take one knot and are vmapped here; the port takes the
[N, nc] stack."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.solver import penalty as jpen
from cafempc_tpu_torch.solver import penalty as pen

TOL = 1e-12
N, NC, XS, US = 16, 8, 6, 4


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.all(np.abs(g.numpy() - w) < TOL)


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(3)
    return dict(
        g=r.uniform(-0.5, 2.0, (N, NC)),
        delta=r.uniform(0.05, 0.3, (N, NC)),
        eps=r.uniform(0.1, 1.0, (N, NC)),
        active=(r.uniform(size=(N, NC)) > 0.3).astype(float),
        gx=r.normal(size=(N, NC, XS)), gu=r.normal(size=(N, NC, US)),
        gy=np.zeros((N, NC, 0)),
        h=r.normal(size=(N, NC)) * 0.01,
        lam=r.normal(size=(N, NC)), sigma=r.uniform(1.0, 50.0, (N, NC)))


@pytest.mark.parametrize("name", ["reb_barrier", "reb_barrier_d",
                                  "reb_cost"])
def test_reb_values(data, name):
    d = data
    args = (d["g"], d["delta"], d["active"]) if name != "reb_cost" else \
        (d["g"], d["delta"], d["eps"], d["active"])
    want = jax.vmap(getattr(jpen, name))(*map(jnp.asarray, args))
    _close(getattr(pen, name)(*map(_t, args)), want)


def test_reb_partials(data):
    d = data
    args = (d["g"], d["gx"], d["gu"], d["gy"], d["delta"], d["eps"],
            d["active"])
    want = jax.vmap(jpen.reb_partials)(*map(jnp.asarray, args))
    _close(pen.reb_partials(*map(_t, args)), tuple(want))


@pytest.mark.parametrize("delta_min", [0.02, 0.2])
def test_reb_update(data, delta_min):
    d = data
    want = jax.vmap(jpen.reb_update_params,
                    in_axes=(0, 0, 0, 0, None, None, None, None))(
        jnp.asarray(d["g"]), jnp.asarray(d["delta"]), jnp.asarray(d["eps"]),
        jnp.asarray(d["active"]), 1e-3, 0.1, 7.0, delta_min)
    got = pen.reb_update_params(_t(d["g"]), _t(d["delta"]), _t(d["eps"]),
                                _t(d["active"]), 1e-3, 0.1, 7.0,
                                _t(delta_min))
    _close(got, tuple(want))


@pytest.mark.parametrize("name", ["al_cost", "al_partials"])
def test_al_values(data, name):
    d = data
    hx = d["gx"]
    args = (d["h"], d["lam"], d["sigma"], d["active"]) if name == "al_cost" \
        else (d["h"], hx, d["lam"], d["sigma"], d["active"])
    want = jax.vmap(getattr(jpen, name))(*map(jnp.asarray, args))
    want = tuple(want) if isinstance(want, tuple) else want
    _close(getattr(pen, name)(*map(_t, args)), want)


@pytest.mark.parametrize("scale", [1e-4, 1e-2, 1.0])
def test_al_update(data, scale):
    """Covers the no-op, lambda and sigma branches of the schedule."""
    d = data
    h = d["h"] / 0.01 * scale
    want = jax.vmap(jpen.al_update_params,
                    in_axes=(0, 0, 0, 0, None, None, None))(
        jnp.asarray(h), jnp.asarray(d["lam"]), jnp.asarray(d["sigma"]),
        jnp.asarray(d["active"]), 1e-3, 8.0, 1e4)
    got = pen.al_update_params(_t(h), _t(d["lam"]), _t(d["sigma"]),
                               _t(d["active"]), 1e-3, 8.0, _t(1e4))
    _close(got, tuple(want))

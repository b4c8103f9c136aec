"""The port's barrel-roll trajectory optimization (`problems/barrel_roll.py`)
against the JAX package, f64 on CPU, on the synthetic quadruped URDF and
the synthetic settings (`reference/synthetic.write_synthetic_br_settings`)
written for the test:

  * the settings loaders, and every array of the plan, the penalties and
    the initial trajectory, equal;
  * every problem function and its partials at a knot of each of the 6
    phases, the 6 phase-terminal knots and the 5 reset steps (2 with a
    touchdown impact, 3 identities), on seeded perturbed states: 1e-10
    normalized by the JAX value's largest entry; the dynamics and reset
    partials (the port's one route, the closed-form factored-KKT
    assembly) against each JAX route: the JAX barrel roll's `jacfwd`
    through the step and the JAX lane module's closed-form partials
    (CAFEMPC_WB_CF=1 there);
  * the forward step, the lane step (`wb_lane.wb_dynamics_lane` and
    `wb_lane.impulse_dynamics_lane`), against the port's AD step
    (`wbm.dynamics`, `wbm.impact`) at 1e-12 in each of the 6 contact
    modes and at each of the 5 reset transitions, on seeded perturbed
    states [B, N]; a B=2 solve never reaches `rbda.contact_kkt_dynamics`
    or `rbda.impulse_dynamics`;
  * the whole 131-knot solve at 1 AL x 2 DDP: the port gathers the 5
    reset steps (`max_resets=16`), the JAX solve selects dynamics or reset
    at every step (`make_solver(..., max_resets=None)`), both with the
    sequential line search.  The port's sweep runs with the JAX un-fused
    sweep's exact Cholesky of Quu - 1e-9 I in place of the Pallas pivot
    scaling (as in test_torch_mhpc_solve.py): Xbar, Ubar and the cost to
    1e-8, iteration counts equal;
  * the same JAX solve against the port's with the same keywords (masked
    resets, the exact sequential sweep, the scan linear rollout, the
    sequential line search), unpatched: to 1e-8, iteration counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import wb_lane as jwl
from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu.problems import barrel_roll as jbr
from cafempc_tpu.solver.hsddp import make_solver as jax_make_solver
from cafempc_tpu.solver.options import SolverOptions as JaxSolverOptions
from cafempc_tpu.solver.plan import host_plan_to_device as jax_to_device
from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.models import rbda, synthetic_robot, wbm
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.parallel.mesh import broadcast_batch
from cafempc_tpu_torch.problems import barrel_roll as br
from cafempc_tpu_torch.reference.synthetic import write_synthetic_br_settings
from cafempc_tpu_torch.solver.hsddp import make_solver
from cafempc_tpu_torch.solver.options import SolverOptions

F64 = torch.float64
TOL = 1e-10
SOLVE_TOL = 1e-8


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("br")
    return (synthetic_robot.write_synthetic_quadruped_urdf(str(d)),
            write_synthetic_br_settings(str(d / "setting")))


@pytest.fixture(scope="module")
def models(files):
    return jwbm.load_model(files[0]), wbm.load_model(files[0], "cpu", F64)


@pytest.fixture(scope="module")
def plans(files):
    """(port's numpy plan tuple, JAX's)."""
    return (br.build_barrel_roll_plan(files[1]),
            jbr.build_barrel_roll_plan(files[1]))


def test_loaders_match_jax(files):
    d = files[1]
    for got, want in zip(br.load_br_cost_weights(f"{d}/br_cost_weights.JSON"),
                         jbr.load_br_cost_weights(
                             f"{d}/br_cost_weights.JSON")):
        np.testing.assert_array_equal(got, want)
    got = br.load_br_constraint_params(f"{d}/br_constraint_params.info")
    assert got == jbr.load_br_constraint_params(
        f"{d}/br_constraint_params.info")
    assert got["GRF"] == dict(delta=0.1, delta_min=0.1, eps=0.3)
    assert got["TD"] == {"lambda": 0.0, "sigma": 20.0, "sigma_max": 1e4}
    np.testing.assert_array_equal(br.initial_state(), jbr.initial_state())
    np.testing.assert_array_equal(br.keyframes(), jbr.keyframes())


def test_plan_matches_jax(plans):
    (plan, pen, Xbar0, Ubar0, meta), want = plans
    got = (plan, pen, Xbar0, Ubar0)
    for name, g, w in zip(("plan", "pen", "Xbar0", "Ubar0"), got, want):
        gl, wl = jax.tree.leaves(g), jax.tree.leaves(w)
        assert len(gl) == len(wl), name
        for a, b in zip(gl, wl):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)
    assert meta["n_knots"] == want[4]["n_knots"] == 131
    assert meta["horizons"] == want[4]["horizons"]
    st = plan.step
    assert st.active.shape == (130,) and st.is_reset.sum() == 5
    assert (st.active * (1 - st.is_reset)).sum() == 125


def _sites(plan):
    """(a mid-phase dynamics step of each phase, the reset steps, the
    phase-terminal knots)."""
    st, kn = plan.step, plan.knot
    resets = np.flatnonzero(st.is_reset > 0)
    starts = np.r_[0, resets + 1]
    ends = np.r_[resets, len(st.active)]
    mid = (starts + ends) // 2
    return mid, resets, np.flatnonzero(kn.is_terminal > 0)


@pytest.fixture(scope="module")
def points(plans):
    """Seeded states near the initial trajectory at every knot, controls
    and GRF outputs at every step."""
    plan, _, Xbar0, Ubar0, _ = plans[0]
    rng = np.random.default_rng(11)
    X = Xbar0 + rng.normal(0, 0.05, Xbar0.shape)
    X[:, 18:] += rng.normal(0, 0.5, (len(X), 18))
    U = rng.normal(0, 4.0, Ubar0.shape)
    Y = rng.normal(0, 20.0, Ubar0.shape)
    return X, U, Y


STEP_FNS = ("dyn", "dyn_partials", "run_cost", "run_cost_partials",
            "path_con", "path_con_partials")
RESET_FNS = ("reset", "reset_partial")
KNOT_FNS = ("term_cost", "term_cost_partials", "term_con",
            "term_con_partials")


@pytest.fixture(scope="module")
def jax_values(models, plans, points):
    """Every JAX problem function vmapped over its sites, in one jitted
    program."""
    plan = jax_to_device(plans[1][0], dtype=jnp.float64)
    mid, resets, term = _sites(plans[0][0])
    X, U, Y = (jnp.asarray(a) for a in points)
    fns = jbr.make_barrel_roll_fns(models[0])

    @jax.jit
    def run():
        out = {}
        for idx, names, args in (
                (mid, STEP_FNS, lambda i: (X[i], U[i], Y[i])),
                (resets, RESET_FNS, lambda i: (X[i],)),
                (term, KNOT_FNS, lambda i: (X[i],))):
            pd = plan.knot if names is KNOT_FNS else plan.step
            pd = jax.tree.map(lambda a: a[idx], pd)
            for n in names:
                a = args(idx)[:2] if n in ("dyn", "dyn_partials") \
                    else args(idx)
                out[n] = jax.vmap(getattr(fns, n))(*a, pd)
        return out
    return jax.tree.map(np.asarray, run())


def _check_against_jax(models, plans, points, jax_values, name):
    """The port's `name` at its sites against JAX's, to TOL."""
    plan = from_numpy(plans[0][0], "cpu", F64)
    mid, resets, term = _sites(plans[0][0])
    X, U, Y = (torch.as_tensor(a)[None] for a in points)
    fns = br.make_barrel_roll_fns(models[1])
    f = getattr(fns, name)
    if name in KNOT_FNS:
        idx = torch.as_tensor(term)
        got = f(X[:, idx], type(plan.knot)(*[a[idx] for a in plan.knot]))
    else:
        idx = torch.as_tensor(resets if name in RESET_FNS else mid)
        sd = type(plan.step)(*[a[idx] for a in plan.step])
        if name in RESET_FNS:
            got = f(X[:, idx], sd)
        elif name in ("dyn", "dyn_partials"):
            got = f(X[:, idx], U[:, idx], sd)
        else:
            got = f(X[:, idx], U[:, idx], Y[:, idx], sd)
    got = to_numpy(got if isinstance(got, tuple) else (got,))
    want = jax_values[name]
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (1,) + w.shape
        np.testing.assert_allclose(g[0], w, rtol=0,
                                   atol=TOL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("name", STEP_FNS + RESET_FNS + KNOT_FNS)
def test_problem_functions_match_jax(models, plans, points, jax_values,
                                     name):
    _check_against_jax(models, plans, points, jax_values, name)


@pytest.fixture(scope="module")
def jax_cf_values(files, plans, points):
    """The JAX lane module's closed-form dynamics partials at the
    mid-phase steps and its impact Jacobians at the reset steps (the
    identity without a touchdown), op by op with the knot axis last, then
    moved first as `jax_values` holds them."""
    jm = jwl.load_lane_model(files[0])
    mid, resets, _ = _sites(plans[0][0])
    st = plans[0][0].step
    X, U, _ = points
    mpatch = pytest.MonkeyPatch()
    mpatch.setenv("CAFEMPC_WB_CF", "1")
    try:
        dyn = jwl.wb_dyn_partials_lane(
            jm, jnp.asarray(X[mid].T), jnp.asarray(U[mid].T),
            jnp.asarray(st.dt[mid]), jnp.asarray(st.contact[mid].T), 10.0)
        c, cn = st.contact[resets], st.contact_next[resets]
        x = X[resets]
        dvq, dvv = jwl.impulse_dynamics_partials_lane(
            jm, jnp.asarray(x[:, :18].T), jnp.asarray(x[:, 18:].T),
            jnp.asarray(((1.0 - c) * cn).T))
    finally:
        mpatch.undo()
    first = [np.moveaxis(np.asarray(a), -1, 0) for a in (*dyn, dvq, dvv)]
    n = len(resets)
    P = np.concatenate([
        np.concatenate([np.broadcast_to(np.eye(18), (n, 18, 18)),
                        np.zeros((n, 18, 18))], -1),
        np.concatenate(first[4:], -1)], -2)
    touch = ((cn - c) > 0.5).any(1)
    P = np.where(touch[:, None, None], P, np.eye(36))
    return dict(dyn_partials=tuple(first[:4]), reset_partial=P)


@pytest.mark.parametrize("route", ["ad", "cf"])
@pytest.mark.parametrize("name", ["dyn_partials", "reset_partial"])
def test_partials_match_each_jax_route(models, plans, points, request, name,
                                       route):
    """The port's one route against the JAX package's forward-mode AD
    through the step ("ad", the JAX barrel roll's own `jacfwd`) and its
    closed-form lane partials ("cf")."""
    values = request.getfixturevalue("jax_values" if route == "ad"
                                     else "jax_cf_values")
    _check_against_jax(models, plans, points, values, name)


def test_reset_is_the_identity_without_a_touchdown(models, plans, points):
    """Of the 5 reset steps, those into stance (after the two flights)
    apply the impact; the others leave the state and give P = I."""
    plan_np = plans[0][0]
    _, resets, _ = _sites(plan_np)
    st = plan_np.step
    touch = ((st.contact_next - st.contact) > 0.5).any(1)[resets]
    assert touch.tolist() == [False, False, True, False, True]
    plan = from_numpy(plan_np, "cpu", F64)
    idx = torch.as_tensor(resets)
    sd = type(plan.step)(*[a[idx] for a in plan.step])
    X = torch.as_tensor(points[0])[None, idx]
    fns = br.make_barrel_roll_fns(models[1])
    xr, P = fns.reset(X, sd)[0], fns.reset_partial(X, sd)[0]
    assert torch.equal(xr[~touch], X[0][~touch])
    assert torch.equal(P[~touch], torch.eye(36, dtype=F64).expand(3, 36, 36))
    assert not torch.equal(xr[touch, 18:], X[0][touch, 18:])


LANE_TOL = 1e-12
# (function, phase or reset site): the dynamics in each phase's contact
# mode, the reset at each of the 5 phase transitions
LANE_CASES = [("dyn", i) for i in range(6)] + [("reset", i) for i in range(5)]


@pytest.mark.parametrize("which,i", LANE_CASES)
def test_lane_step_matches_wbm_step(models, plans, which, i):
    """`dyn` (the lane step) against `wbm.dynamics`, and `reset` (the lane
    impulse where a foot touches down) against `wbm.impact` where one
    does, at B x N = 3 x 8 seeded states near the initial trajectory of
    the phase or reset site: 1e-12, normalized by the AD value's largest
    entry."""
    plan_np, _, Xbar0, _, _ = plans[0]
    plan = from_numpy(plan_np, "cpu", F64)
    st = plan_np.step
    resets = np.flatnonzero(st.is_reset > 0)
    rng = np.random.default_rng(100 + 10 * i + (which == "reset"))
    if which == "dyn":
        lo = 0 if i == 0 else resets[i - 1] + 1
        hi = resets[i] if i < 5 else len(st.active)
        idx = rng.choice(np.arange(lo, hi), 8)
    else:
        idx = np.full(8, resets[i])
    X = Xbar0[idx] + rng.normal(0, 0.05, (3, 8, 36))
    X[..., 18:] += rng.normal(0, 0.5, (3, 8, 18))
    X = torch.as_tensor(X)
    sd = type(plan.step)(*[a[torch.as_tensor(idx)] for a in plan.step])
    fns = br.make_barrel_roll_fns(models[1])
    c = sd.contact.expand(3, 8, 4)
    if which == "dyn":
        U = torch.as_tensor(rng.normal(0, 4.0, (3, 8, 12)))
        assert torch.equal(c[0, 0], torch.as_tensor(br.CONTACTS[i]))
        got = fns.dyn(X, U, sd)
        want = wbm.dynamics(models[1], X, U, sd.dt.expand(3, 8), c, 10.0)
    else:
        cn = sd.contact_next.expand(3, 8, 4)
        touch = ((cn - c) > 0.5).any(-1)
        # the touchdowns are the transitions out of the two flights
        assert touch.all() == touch.any() == (i in (2, 4))
        ximp, _ = wbm.impact(models[1], X, c, cn)
        got = (fns.reset(X, sd),)
        want = (torch.where(touch[..., None], ximp, X),)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=LANE_TOL * max(1.0, w.abs().max()))


def test_solve_never_reaches_the_ad_step(models, plans, monkeypatch):
    """A B=2 solve with the AD step's KKT solves (`rbda.
    contact_kkt_dynamics`, `rbda.impulse_dynamics`) made to raise: the
    trial rollouts step with the lane forms, so it runs to its end."""
    def refuse(*a, **k):
        raise AssertionError("the barrel roll reached the AD step")
    monkeypatch.setattr(rbda, "contact_kkt_dynamics", refuse)
    monkeypatch.setattr(rbda, "impulse_dynamics", refuse)
    plan_np, pen_np, Xbar0, Ubar0, _ = plans[0]
    x = torch.zeros(1, 36, dtype=F64)
    with pytest.raises(AssertionError, match="AD step"):
        wbm.dynamics(models[1], x, torch.zeros(1, 12, dtype=F64),
                     torch.full((1,), 0.01, dtype=F64),
                     torch.ones(1, 4, dtype=F64))
    plan, pen, Xbar0, Ubar0 = from_numpy((plan_np, pen_np, Xbar0, Ubar0),
                                         "cpu", F64)
    x0 = np.tile(br.initial_state(), (2, 1))
    x0[:, 18:21] += np.random.default_rng(2).normal(0.0, 0.2, (2, 3))
    solve = make_solver(br.make_barrel_roll_fns(models[1]),
                        SolverOptions(max_AL_iter=1, max_DDP_iter=1),
                        fused_riccati=True, parallel_line_search=False,
                        max_resets=16)
    res = solve(plan, broadcast_batch(pen, 2), torch.as_tensor(x0),
                broadcast_batch(Xbar0, 2), broadcast_batch(Ubar0, 2))
    assert torch.isfinite(res.cost).all() and torch.isfinite(res.Xbar).all()
    assert (res.info.iters == 1).all()


OPTS = dict(max_AL_iter=1, max_DDP_iter=2)


@pytest.fixture(scope="module")
def jax_solve(models, plans):
    plan_np, pen_np, Xbar0, Ubar0, _ = plans[1]
    solve = jax.jit(jax_make_solver(
        jbr.make_barrel_roll_fns(models[0]), JaxSolverOptions(**OPTS),
        parallel_line_search=False, trim_output=True))
    res = solve(jax_to_device(plan_np, dtype=jnp.float64),
                jax.tree.map(lambda a: jnp.asarray(np.asarray(a),
                                                   jnp.float64), pen_np),
                jnp.asarray(jbr.initial_state()), jnp.asarray(Xbar0),
                jnp.asarray(Ubar0))
    return jax.tree.map(np.asarray, res)


def _exact_cholesky(Quu):
    """Cholesky factor of Quu - 1e-9 I, as the JAX un-fused sweep takes it."""
    eye = torch.eye(Quu.shape[-1], dtype=Quu.dtype)
    L, info = torch.linalg.cholesky_ex(Quu - 1e-9 * eye)
    return L, info == 0


def test_solve_matches_jax_masked_resets(models, plans, jax_solve,
                                         monkeypatch):
    monkeypatch.setattr(sweep_mod, "cholesky_pivot_rule", _exact_cholesky)
    plan_np, pen_np, Xbar0, Ubar0, _ = plans[0]
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, br.initial_state(), Xbar0, Ubar0), "cpu", F64)
    solve = make_solver(br.make_barrel_roll_fns(models[1]),
                        SolverOptions(**OPTS), fused_riccati=True,
                        parallel_line_search=False, max_resets=16)
    got = to_numpy(solve(plan, broadcast_batch(pen, 1), x0[None],
                         Xbar0[None], Ubar0[None]))
    want = jax_solve
    assert got.success[0] and want.success
    for f in ("iters", "ls_iters", "reg_iters", "n_entries"):
        assert getattr(got.info, f)[0] == getattr(want.info, f), f
    assert want.info.iters == 2
    np.testing.assert_allclose(got.Xbar[0], want.Xbar, rtol=0,
                               atol=SOLVE_TOL)
    np.testing.assert_allclose(got.Ubar[0], want.Ubar, rtol=0,
                               atol=SOLVE_TOL)
    np.testing.assert_allclose(got.cost[0], want.cost, rtol=SOLVE_TOL,
                               atol=0)
    np.testing.assert_allclose(got.max_tconstr[0], want.max_tconstr,
                               rtol=0, atol=SOLVE_TOL)


def test_solve_with_the_same_keywords_matches_jax(models, plans, jax_solve):
    """The port's masked-reset solve, configured as the JAX solve is
    (`parallel_line_search=False`, the rest make_solver's defaults)."""
    plan_np, pen_np, Xbar0, Ubar0, _ = plans[0]
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, br.initial_state(), Xbar0, Ubar0), "cpu", F64)
    solve = make_solver(br.make_barrel_roll_fns(models[1]),
                        SolverOptions(**OPTS), parallel_line_search=False)
    got = to_numpy(solve(plan, broadcast_batch(pen, 1), x0[None],
                         Xbar0[None], Ubar0[None]))
    want = jax_solve
    assert got.success[0] and want.success
    for f in ("iters", "ls_iters", "reg_iters", "n_entries"):
        assert getattr(got.info, f)[0] == getattr(want.info, f), f
    for f in ("Xbar", "Ubar", "max_tconstr"):
        np.testing.assert_allclose(getattr(got, f)[0], getattr(want, f),
                                   rtol=0, atol=SOLVE_TOL, err_msg=f)
    np.testing.assert_allclose(got.cost[0], want.cost, rtol=SOLVE_TOL,
                               atol=0)
    np.testing.assert_allclose(got.info.cost_buf[0], want.info.cost_buf,
                               rtol=SOLVE_TOL, atol=0)

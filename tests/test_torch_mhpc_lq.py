"""One LQ stage of the port's MHPC cascade per segment against the JAX
package, f64 on CPU, on the synthetic quadruped and the urdf-order
synthetic bound reference at the production plan (`n_steps_max=48`,
`wb_block=32`: 25 WB + 10 SRB knots).

Each problem function of the port's two segments (WB steps [0, 32), SRB
tail [32, 48) plus the final knot), through the solver's segment fan-out,
against the JAX per-knot function (`make_mhpc_fns(..., mode=...)` with
CAFEMPC_WB_LANE=0) vmapped over the segment's knots and a batch of 2: the
dynamics and A-D, lx-lyy, phix and phixx, g and h and their partials, and
the reset partials at the gathered reset sites; tolerance 1e-10 on the
error normalized by the JAX value's max |value|.  Each JAX function is
jitted (the WB partials compile in ~35 s; op by op they take twice that).
test_torch_mhpc_lane.py holds the port's WB functions to the JAX lane
overrides, the JAX package's default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu.problems import mhpc_problem as jmp
from cafempc_tpu.solver.plan import host_plan_to_device as jax_to_device
from cafempc_tpu_torch.convert import from_numpy
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.reference.synthetic import \
    synthetic_bound_reference_urdf
from cafempc_tpu_torch.solver import hsddp

F64 = torch.float64
B = 2
TOL = 1e-10


@pytest.fixture(scope="module")
def urdf_path(tmp_path_factory):
    return synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))


@pytest.fixture(scope="module")
def problem():
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(0.75)
    cfg = mp.MHPCConfig()
    plan_np, _, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, cfg)
    rng = np.random.default_rng(11)
    X = Xbar0[None] + rng.normal(0, 0.02, (B,) + Xbar0.shape)
    U = rng.normal(0, 2.0, (B,) + Ubar0.shape)
    Y = rng.normal(0, 20.0, (B,) + Ubar0.shape)
    return cfg, plan_np, X, U, Y


@pytest.fixture(scope="module")
def port(urdf_path, problem):
    cfg, plan_np, X, U, Y = problem
    model = wbm.load_model(urdf_path, "cpu", F64)
    fns = mp.make_mhpc_fns_segmented(cfg, model)
    plan = from_numpy(plan_np, "cpu", F64)
    return fns, plan, [torch.as_tensor(a) for a in (X, U, Y)]


@pytest.fixture(scope="module")
def jax_fns(urdf_path, problem):
    """The JAX per-knot fns of each segment (CAFEMPC_WB_LANE=0)."""
    cfg = problem[0]
    mpatch = pytest.MonkeyPatch()
    mpatch.setenv("CAFEMPC_WB_LANE", "0")
    try:
        seg = jmp.make_mhpc_fns_segmented(
            jmp.MHPCConfig(**vars(cfg)), jwbm.load_model(urdf_path),
            urdf=urdf_path)
    finally:
        mpatch.undo()
    return seg


# (problem function, per-step or per-knot, argument layout)
STEP_FNS = ["dyn", "dyn_partials", "run_cost", "run_cost_partials",
            "path_con", "path_con_partials"]
KNOT_FNS = ["term_cost", "term_cost_partials", "term_con",
            "term_con_partials"]


def _vmap2(f, n_batched):
    """A per-knot function of n_batched per-scenario arguments and a plan
    row, jitted and vmapped over knots, then over scenarios."""
    per_knot = jax.vmap(f, in_axes=(0,) * (n_batched + 1))
    return jax.jit(jax.vmap(per_knot, in_axes=(0,) * n_batched + (None,)))


def _jax_segment(jf, name, X, U, Y, pd):
    """JAX per-knot function `name` over a segment's knots and scenarios."""
    f = getattr(jf, name)
    if name in KNOT_FNS:
        return _vmap2(f, 1)(X, pd)
    if name in ("dyn", "dyn_partials"):
        return _vmap2(f, 2)(X, U, pd)
    return _vmap2(f, 3)(X, U, Y, pd)


def _close(got, want, what):
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (what, i, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= TOL, (what, i, err)


@pytest.mark.parametrize("name", STEP_FNS + KNOT_FNS)
def test_fan_out_matches_jax_per_knot(port, jax_fns, problem, name):
    """The port's function over the whole plan (its two segments through
    the solver's fan-out) equals the JAX per-knot function of each
    segment on that segment's slice, concatenated."""
    cfg, plan_np, X, U, Y = problem
    fns, plan, (Xt, Ut, Yt) = port
    N = cfg.n_steps_max
    knot = name in KNOT_FNS
    pd_t = plan.knot if knot else plan.step
    args = ((Xt,) if knot else (Xt[:, :-1], Ut) if name.startswith("dyn")
            else (Xt[:, :-1], Ut, Yt))
    got = hsddp._fan_out(fns, name, N, 1 if knot else 0)(*args, pd_t)

    jplan = jax_to_device(plan_np, dtype=jnp.float64)
    outs, o = [], 0
    for i, (cnt, jf) in enumerate(zip(jax_fns.counts, jax_fns.fns)):
        c = cnt + (1 if knot and i == 1 else 0)
        pd = jax.tree.map(lambda a: a[o:o + c],
                          jplan.knot if knot else jplan.step)
        if knot:
            outs.append(_jax_segment(jf, name, X[:, o:o + c], None, None, pd))
        else:
            outs.append(_jax_segment(jf, name, X[:, o:o + c], U[:, o:o + c],
                                     Y[:, o:o + c], pd))
        o += c
    if isinstance(outs[0], tuple):
        want = tuple(np.concatenate([np.asarray(s[k]) for s in outs], 1)
                     for k in range(len(outs[0])))
    else:
        want = np.concatenate([np.asarray(s) for s in outs], 1)
    _close(got, want, name)


@pytest.mark.parametrize("name", ["reset", "reset_partial"])
def test_reset_at_gathered_sites_matches_jax(port, jax_fns, problem, name):
    """The reset map and its partial at the reset sites gathered per
    segment (the WB segment's intra-WB resets, carry-pad identity resets
    and the model switch; the SRB segment has none) against the JAX
    per-knot reset of the WB segment at the same steps."""
    cfg, plan_np, X, _, _ = problem
    fns, plan, (Xt, _, _) = port
    sites = hsddp.reset_sites(plan, 16, fns)
    assert [int(s.valid.sum()) for s in sites] == [7, 0]
    wb_sites = sites[0]
    idx = wb_sites.idx[wb_sites.valid]
    assert idx.tolist() == list(np.nonzero(plan_np.step.is_reset)[0])
    assert plan_np.step.model_switch[idx.tolist()].tolist() == \
        [0.0] * 6 + [1.0]
    got = getattr(wb_sites.fns, name)(Xt[:, idx], type(plan.step)(
        *[a[idx] for a in plan.step]))
    jplan = jax_to_device(plan_np, dtype=jnp.float64)
    ii = np.asarray(idx)
    sd = jax.tree.map(lambda a: a[ii], jplan.step)
    want = _vmap2(getattr(jax_fns.fns[0], name), 1)(X[:, ii], sd)
    _close(got, want, name)

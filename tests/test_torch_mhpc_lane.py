"""The port's MHPC whole-body segment functions against the JAX lane
overrides (`cafempc_tpu/problems/mhpc_lane.py`, the JAX package's default
WB path), f64 on CPU, on the synthetic quadruped and the urdf-order
synthetic bound reference at the production plan.  The JAX lane functions
run un-jitted on six knots of one scenario (dynamics steps, an intra-WB
reset, a carry-pad reset and the model switch), as test_torch_wb_lane.py
runs the lane forms; tolerance 1e-10 on the error normalized by the JAX
value's max |value|.  test_torch_mhpc_lq.py holds the same functions to
the JAX per-knot path.
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

F64 = torch.float64
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
    rng = np.random.default_rng(12)
    X = Xbar0 + rng.normal(0, 0.02, Xbar0.shape)
    U = rng.normal(0, 2.0, Ubar0.shape)
    Y = rng.normal(0, 20.0, Ubar0.shape)
    return cfg, plan_np, X, U, Y


@pytest.fixture(scope="module")
def port_wb(urdf_path, problem):
    cfg, plan_np = problem[:2]
    model = wbm.load_model(urdf_path, "cpu", F64)
    return mp.make_mhpc_fns(cfg, model, "wb"), from_numpy(plan_np, "cpu",
                                                          F64)


@pytest.fixture(scope="module")
def jax_lane(urdf_path, problem):
    cfg = problem[0]
    return jmp.make_mhpc_fns(jmp.MHPCConfig(**vars(cfg)),
                             jwbm.load_model(urdf_path), mode="wb",
                             urdf=urdf_path)


def _close(got, want, what):
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, (what, i, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= TOL, (what, i, err)


# the JAX lane overrides of the WB segment (mhpc_lane.py), by the port's
# function they compute
LANE = {"dyn": "dyn_batch", "dyn_partials": "dyn_partials_batch",
        "reset": "reset_batch", "reset_partial": "reset_partial_batch",
        "run_cost": "run_cost_batch",
        "run_cost_partials": "run_cost_partials_batch",
        "term_cost": "term_cost_batch",
        "term_cost_partials": "term_cost_partials_batch",
        "term_con": "term_con_batch",
        "term_con_partials": "term_con_partials_batch"}
LANE_STEPS = [3, 4, 5, 26, 30, 31]   # dynamics, intra-WB reset, carry-pad,
#                                      model switch


@pytest.mark.parametrize("name", sorted(LANE))
def test_wb_fns_match_jax_lane_overrides(port_wb, jax_lane, problem, name):
    """The port's WB functions on a few knots against the JAX lane
    overrides, called un-jitted on the same knots."""
    _, plan_np, X, U, Y = problem
    wb, plan = port_wb
    Xt, Ut, Yt = (torch.as_tensor(a)[None] for a in (X, U, Y))
    ii = np.array(LANE_STEPS)
    knot = name.startswith("term")
    jplan = jax_to_device(plan_np, dtype=jnp.float64)
    pd = jax.tree.map(lambda a: a[ii], jplan.knot if knot else jplan.step)
    pt = type(plan.step)(*[a[ii] for a in plan.step]) if not knot else \
        type(plan.knot)(*[a[ii] for a in plan.knot])
    x, u, y = (jnp.asarray(a[ii]) for a in (X, U, Y))
    f = getattr(jax_lane, LANE[name])
    if knot or name.startswith("reset"):
        want = f(x, pd)
        got = getattr(wb, name)(Xt[:1, ii], pt)
    elif name.startswith("dyn"):
        want = f(x, u, pd)
        got = getattr(wb, name)(Xt[:1, ii], Ut[:1, ii], pt)
    else:
        want = f(x, u, y, pd)
        got = getattr(wb, name)(Xt[:1, ii], Ut[:1, ii], Yt[:1, ii], pt)
    if isinstance(want, tuple):
        want = tuple(np.asarray(w)[None] for w in want)
    else:
        want = np.asarray(want)[None]
    _close(got, want, name)

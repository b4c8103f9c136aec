"""The port's MHPC joint mode (`make_mhpc_fns(cfg, model)`, the JAX
package's default) and its WB partials against the JAX AD partials
(CAFEMPC_WB_AD_PARTIALS=1 there), f64 on CPU, on the synthetic quadruped
and the urdf-order synthetic bound reference at the small plan of the
JAX package's
tests/test_mhpc_segmented.py (WB 0.1 s, SRB 0.2 s, `n_steps_max=24`,
`wb_block=16`).

  * every joint-mode function over the whole plan, and mode "wb"'s
    dynamics and reset partials (the closed-form factored-KKT assembly)
    over the WB segment, against the JAX per-knot functions
    (`make_mhpc_fns(cfg, model)`; mode "wb" under
    CAFEMPC_WB_AD_PARTIALS=1, forward-mode AD) jitted and vmapped over
    knots and a batch of 2, as in test_torch_mhpc_lq.py: 1e-10 on the
    error normalized by the JAX value's max |value| (the AD mode's other
    functions are the JAX per-knot "wb" functions that
    test_torch_mhpc_lq.py holds);
  * the port's joint solve against its segmented solve at
    tests/test_mhpc_segmented.py's tolerances, and gathered against masked
    resets on the joint functions (that file's
    test_gather_reset_matches_masked tolerances);
  * `MHPCRuntime(segmented=False)` against `segmented=None` over
    initialize and one update (commands 1e-7 relative).
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
from cafempc_tpu_torch.parallel.mesh import (broadcast_batch,
                                             make_batched_solver)
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import \
    synthetic_bound_reference_urdf
from cafempc_tpu_torch.runtime.mhpc_runtime import MHPCRuntime
from cafempc_tpu_torch.solver.options import SolverOptions
from torch_port_inputs import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F64 = torch.float64
B = 2
TOL = 1e-10
PLAN = dict(plan_dur_wb=0.1, plan_dur_srb=0.2, n_steps_max=24, wb_block=16)
OPTS = SolverOptions(max_AL_iter=2, max_DDP_iter=2)
KW = dict(trim_output=False, parallel_line_search=False, fused_riccati=True,
          reg_floor=1e-3)
STEP_FNS = {"dyn": 2, "dyn_partials": 2, "reset": 1, "reset_partial": 1,
            "run_cost": 3, "run_cost_partials": 3, "path_con": 3,
            "path_con_partials": 3}
KNOT_FNS = ["term_cost", "term_cost_partials", "term_con",
            "term_con_partials"]


@pytest.fixture(scope="module")
def urdf_path(tmp_path_factory):
    return synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))


@pytest.fixture(scope="module")
def model(urdf_path):
    return wbm.load_model(urdf_path, "cpu", F64)


@pytest.fixture(scope="module")
def problem():
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(0.4)
    cfg = mp.MHPCConfig(**PLAN)
    plan_np, pen_np, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, cfg)
    rng = np.random.default_rng(11)
    X = Xbar0[None] + rng.normal(0, 0.02, (B,) + Xbar0.shape)
    U = rng.normal(0, 2.0, (B,) + Ubar0.shape)
    Y = rng.normal(0, 20.0, (B,) + Ubar0.shape)
    x0 = wb_state_ref_at(qr, 0.0)[None] \
        + np.random.default_rng(3).normal(0, 0.01, (B, mp.XS))
    return dict(cfg=cfg, plan_np=plan_np, pen_np=pen_np, Xbar0=Xbar0,
                Ubar0=Ubar0, x0=x0, X=X, U=U, Y=Y)


def _args(name, X, U, Y):
    """A function's state, control and output arguments, per step or per
    knot."""
    if name in KNOT_FNS:
        return (X,)
    return (X[:, :-1], U, Y)[:STEP_FNS[name]]


def _jax_fns(urdf_path, cfg, mode, env):
    mpatch = pytest.MonkeyPatch()
    for k, v in env.items():
        mpatch.setenv(k, v)
    try:
        return jmp.make_mhpc_fns(jmp.MHPCConfig(**vars(cfg)),
                                 jwbm.load_model(urdf_path), mode=mode,
                                 urdf=urdf_path)
    finally:
        mpatch.undo()


def _jax_eval(f, args, pd):
    """A JAX per-knot function, jitted and vmapped over knots, then over
    scenarios."""
    n = len(args)
    per_knot = jax.vmap(f, in_axes=(0,) * (n + 1))
    return jax.jit(jax.vmap(per_knot, in_axes=(0,) * n + (None,)))(*args, pd)


def _close(got, want, what):
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (what, i, g.shape, w.shape)
        assert np.isfinite(w).all(), (what, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= TOL, (what, i, err)


@pytest.fixture(scope="module")
def joint_pair(urdf_path, model, problem):
    return (mp.make_mhpc_fns(problem["cfg"], model),
            _jax_fns(urdf_path, problem["cfg"], "joint", {}))


@pytest.mark.parametrize("name", list(STEP_FNS) + KNOT_FNS)
def test_joint_fns_match_jax(joint_pair, problem, name):
    """A joint-mode function over every step (or knot) of the plan, both
    models and the padding included, against the JAX joint function."""
    fns, jf = joint_pair
    p = problem
    plan = from_numpy(p["plan_np"], "cpu", F64)
    jplan = jax_to_device(p["plan_np"], dtype=jnp.float64)
    knot = name in KNOT_FNS
    got = getattr(fns, name)(
        *[torch.as_tensor(a) for a in _args(name, p["X"], p["U"], p["Y"])],
        plan.knot if knot else plan.step)
    want = _jax_eval(getattr(jf, name), _args(name, p["X"], p["U"], p["Y"]),
                     jplan.knot if knot else jplan.step)
    _close(got, want, name)


@pytest.mark.parametrize("name", ["dyn_partials", "reset_partial"])
def test_ad_partials_match_jax(urdf_path, model, problem, name):
    """Mode "wb"'s dynamics and reset partials over the WB segment's steps
    against the JAX AD-mode functions: the forward-mode Jacobians of the
    dynamics and of the reset."""
    p = problem
    wb = p["cfg"].wb_block
    fns = mp.make_mhpc_fns(p["cfg"], model, "wb")
    jf = _jax_fns(urdf_path, p["cfg"], "wb",
                  {"CAFEMPC_WB_AD_PARTIALS": "1"})
    args = [a[:, :wb] for a in _args(name, p["X"][:, :wb + 1], p["U"],
                                     p["Y"])]
    sd = from_numpy(p["plan_np"], "cpu", F64).step
    got = getattr(fns, name)(*[torch.as_tensor(a) for a in args],
                             type(sd)(*[a[:wb] for a in sd]))
    jsd = jax.tree.map(lambda a: a[:wb],
                       jax_to_device(p["plan_np"], dtype=jnp.float64).step)
    _close(got, _jax_eval(getattr(jf, name), args, jsd), name)


@pytest.fixture(scope="module")
def solves(model, problem):
    """The port's segmented solve, its joint solve with gathered resets
    and with masked resets (max_resets=None), B=2, 2 AL x 2 DDP."""
    p = problem
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (p["plan_np"], p["pen_np"], p["x0"], p["Xbar0"], p["Ubar0"]), "cpu",
        F64)
    args = (plan, broadcast_batch(pen, B), x0, broadcast_batch(Xbar0, B),
            broadcast_batch(Ubar0, B))
    joint = mp.make_mhpc_fns(p["cfg"], model)
    return {name: make_batched_solver(fns, OPTS, max_resets=mr, **KW)(*args)
            for name, fns, mr in (
                ("segmented", mp.make_mhpc_fns_segmented(p["cfg"], model),
                 16),
                ("joint", joint, 16), ("masked", joint, None))}


def test_joint_solve_matches_segmented(solves):
    """tests/test_mhpc_segmented.py::test_segmented_matches_joint's
    tolerances."""
    s, j = solves["segmented"], solves["joint"]
    np.testing.assert_allclose(s.traj.Xbar, j.traj.Xbar, rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(s.traj.Ubar, j.traj.Ubar, rtol=1e-7,
                               atol=1e-8)
    np.testing.assert_allclose(s.cost, j.cost, rtol=1e-9)
    np.testing.assert_allclose(s.traj.K, j.traj.K, rtol=1e-6, atol=1e-7)
    assert bool(s.success.all()) and bool(j.success.all())
    assert torch.equal(s.info.iters, j.info.iters)


def test_gather_reset_matches_masked(solves):
    """tests/test_mhpc_segmented.py::test_gather_reset_matches_masked's
    tolerances, on the joint functions."""
    g, m = solves["joint"], solves["masked"]
    np.testing.assert_allclose(g.traj.Xbar, m.traj.Xbar, rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(g.cost, m.cost, rtol=1e-10)


def test_runtime_joint_matches_segmented(model, monkeypatch):
    """MHPCRuntime(segmented=False) solves with the joint functions;
    initialize and one update give the segmented runtime's commands."""
    modes, real = [], mp.make_mhpc_fns
    monkeypatch.setattr(mp, "make_mhpc_fns", lambda cfg, model, mode="joint":
                        modes.append(mode) or real(cfg, model, mode))
    tapes = []
    for segmented in (None, False):
        qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
        qr.initialize(0.4)
        rt = MHPCRuntime(qr, mp.MHPCConfig(**PLAN),
                         SolverOptions(max_AL_iter=2, max_DDP_iter=2,
                                       max_AL_iter_runtime=1,
                                       max_DDP_iter_runtime=2),
                         model=model, device="cpu", segmented=segmented)
        x = wb_state_ref_at(qr, 0.0)
        tapes.append([rt.initialize(x), rt.update(x)])
        assert rt.result["success"]
    assert modes == ["wb", "srb", "joint"]
    for seg, joint in zip(*tapes):
        for k in ("torque", "pos", "qJ", "GRF", "feedback", "Quu"):
            a, b = getattr(seg, k), getattr(joint, k)
            np.testing.assert_allclose(b, a, rtol=1e-7,
                                       atol=1e-7 * np.abs(a).max())

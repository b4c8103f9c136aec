"""The port's fused HKD LQ and trial paths against the JAX package, f64 on
CPU.

* `hkd_lq_reference` (the twin of the CUDA LQ kernel) against the JAX
  `_lq_op` fallback per scenario on the 72-step plan, against the Pallas
  kernel `fused_hkd_lq` in interpret mode (through `jax.vmap(_lq_op)`) on
  a 9-knot plan, and against the port's own generic LQ stage: the sweep
  operands of the first backward sweep of a solve with and without the
  fused LQ hook.
* `hkd_trial_reference` against the `_trial_op` fallback at the plan's dt
  and against the Pallas kernel `fused_hkd_trial` in interpret mode on the
  9-knot plan at dt = 2**-7.  The Pallas trial kernel rounds its flag
  table, dt included, to float32 even in float64 (fused_hkd_trial.py:421);
  2**-7 is exact in float32, so the comparison sees the kernel's math and
  not that rounding.
* `plan_consts` against the JAX `_plan_consts`.
* A B=2 solve through both fused hooks (the CPU twins) against the JAX
  generic batched solve and the JAX fused batched solve (Pallas kernels in
  interpret mode).

Operands are jittered from the plan with numpy (seeded): ground forces
spread across the relaxed barrier's threshold delta, so both of its
branches are active, per-scenario eps in (0, 1], and one scenario driven
to a huge state so that its trial is not `ok`.  Kernel-level tolerance:
1e-12 of the reference's max |value|.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.parallel.mesh import make_batched_solver as jax_batched
from cafempc_tpu.problems import hkd_fused as jhf
from cafempc_tpu.problems import hkd_problem as jhp
from cafempc_tpu.solver.plan import host_plan_to_device as jax_to_device
from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.ops import hkd_lq as lq_mod
from cafempc_tpu_torch.ops import hkd_table
from cafempc_tpu_torch.ops import hkd_trial as trial_mod
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.parallel.mesh import (broadcast_batch,
                                             make_batched_solver)
from cafempc_tpu_torch.problems import hkd_fused as hf
from cafempc_tpu_torch.problems import hkd_problem as hp
from test_torch_hkd_solve import (B, JAX_OPTS, KW, OPTS,  # noqa: F401
                                  _qr, jax_result, problem)
from torch_port_inputs import HKD_LQ_IN, HKD_TRIAL_IN, hkd_operands

RTOL = 1e-12        # of the reference's max |value|
LQ_FIELDS = ("A", "B", "lx", "lu", "lxx", "luu", "phix", "phixx")
TRIAL_FIELDS = ("X", "U", "Xsim", "Defect", "g", "h", "cq", "cost", "feas",
                "maxp", "maxt", "ok")
CONST_ORDER = ("xref_s", "uref_s", "q_w", "r_w", "qfoot_r", "prelref_r",
               "c3", "swing3", "td4", "lo4", "xref_k", "qf_t", "qfoot_t",
               "prelref_t")


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want[np.isfinite(want)]).max(initial=0.0)),
                1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale,
                               err_msg=name)


def _plan(plan_duration, n_steps, dt=None):
    plan_np, pen_np, Xbar0, Ubar0, _ = hp.build_hkd_plan(
        _qr(plan_duration), hp.HKDConfig(plan_duration=plan_duration,
                                         n_steps_max=n_steps))
    if dt is not None:
        plan_np = plan_np._replace(step=plan_np.step._replace(
            dt=np.full(n_steps, dt)))
    return plan_np, pen_np, Xbar0, Ubar0


def _operands(plan_np, pen_np, Xbar0, Ubar0, n_scen, seed):
    d = hkd_operands(plan_np, pen_np, Xbar0, Ubar0, n_scen, seed)
    on = d["reb_act"] > 0
    g = np.asarray(lq_mod.friction_values(torch.as_tensor(d["U"]),
                                          hp.MU_FRIC))
    assert (g[on] > d["reb_delta"][on]).any()      # log branch
    assert (g[on] <= d["reb_delta"][on]).any()     # quadratic branch
    return d


def _jax_consts(plan_np):
    """The JAX plan, its `_plan_consts` and the fused ops' per-knot constant
    operands in their argument order."""
    plan = jax_to_device(plan_np, jnp.float64)
    cc = jhf._plan_consts(plan, jnp.float64)
    sd, kd = plan.step, plan.knot
    const = dict(cc, xref_s=sd.x_ref, uref_s=sd.u_ref, xref_k=kd.x_ref)
    return plan, cc, [const[k] for k in CONST_ORDER]


def _port_lq(plan_np, d):
    plan = from_numpy(plan_np, "cpu", torch.float64)
    args = [torch.as_tensor(d[k]) for k in HKD_LQ_IN]
    return lq_mod.hkd_lq(*args, hf.knot_table(plan), hp.MU_FRIC)


def _port_trial(plan_np, d):
    plan = from_numpy(plan_np, "cpu", torch.float64)
    args = [torch.as_tensor(d[k]) for k in HKD_TRIAL_IN]
    return trial_mod.hkd_trial(*args, hf.knot_table(plan), hp.MU_FRIC)


def _jax_lq_args(plan_np, d):
    plan, cc, consts = _jax_consts(plan_np)
    sd = plan.step
    lanes = [jnp.asarray(d[k]) for k in HKD_LQ_IN]
    flags = [sd.dt, cc["run_m"], sd.is_reset, sd.active, cc["term_m"]]
    return lanes, consts + flags


def _jax_trial_args(plan_np, d):
    plan, cc, consts = _jax_consts(plan_np)
    sd, kd = plan.step, plan.knot
    lanes = [jnp.asarray(d[k]) for k in HKD_TRIAL_IN]
    flags = [sd.dt, cc["run_m"], sd.is_reset, cc["prev_act"], kd.active,
             cc["term_m"]]
    return lanes, consts + flags


@pytest.fixture(scope="module")
def plan72():
    return _plan(0.6, 72)


def test_kernel_table_layout_matches_python():
    """The column offsets the CUDA kernels read (`csrc/hkd_common.cuh`)
    are those `ops/hkd_table.py` packs."""
    src = (pathlib.Path(hkd_table.__file__).parent / "csrc"
           / "hkd_common.cuh").read_text()
    block = re.search(r"namespace col \{(.*?)\}", src, re.S).group(1)
    got = {k.lower(): int(v) for k, v in re.findall(r"(\w+) = (\d+)", block)}
    names = {"qw": "q_w", "rw": "r_w", "c3": "c3", "run": "run_m",
             "reset": "is_reset", "kact": "k_act", "term": "term_m"}
    want = {k: at for k, (at, _) in hkd_table.OFFSETS.items()}
    want["ncols"] = hkd_table.NCOLS
    assert {names.get(k, k): v for k, v in got.items()} == want


def test_plan_consts_match_jax(plan72):
    plan_np = plan72[0]
    want = jhf._plan_consts(jax_to_device(plan_np, jnp.float64), jnp.float64)
    got = hf.plan_consts(from_numpy(plan_np, "cpu", torch.float64),
                         torch.float64)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_lq_twin_matches_jax_fallback(plan72):
    """Per scenario against the un-batched `_lq_op` (plain JAX)."""
    d = _operands(*plan72, n_scen=2, seed=3)
    got = _port_lq(plan72[0], d)
    lanes, rest = _jax_lq_args(plan72[0], d)
    for b in range(2):
        want = jhf._lq_op(*[a[b] for a in lanes], *rest)
        for name, g, w in zip(LQ_FIELDS, got, want):
            _close(g[b], w, f"{name}[{b}]")


def test_lq_twin_matches_pallas_kernel():
    """Against the Pallas kernel in interpret mode (9 knots, one reset
    step, one padding step, 128 lanes)."""
    plan_np = _plan(0.06, 8)[0]
    assert plan_np.step.is_reset.sum() == 1 and plan_np.step.active[-1] == 0
    d = _operands(*_plan(0.06, 8), n_scen=2, seed=4)
    got = _port_lq(plan_np, d)
    lanes, rest = _jax_lq_args(plan_np, d)
    want = jax.vmap(jhf._lq_op, in_axes=(0,) * len(lanes)
                    + (None,) * len(rest))(*lanes, *rest)
    for name, g, w in zip(LQ_FIELDS, got, want):
        _close(g, w, name)


def test_lq_twin_matches_generic_lq_stage(problem, monkeypatch):
    """The operands of the first backward sweep of a solve, with the fused
    LQ hook and with the generic lq_approx (same rollouts)."""
    seen = []

    def recording_sweep(*args):
        seen.append(args)
        return sweep_mod.sweep_reference(*args)

    monkeypatch.setattr(sweep_mod, "sweep", recording_sweep)
    plan_np, pen_np, Xbar0, Ubar0, x0 = problem
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), "cpu", torch.float64)
    args = (plan, broadcast_batch(pen, B), x0, broadcast_batch(Xbar0, B),
            broadcast_batch(Ubar0, B))
    first = []
    for hook in (None, hf.make_hkd_fused_lq()):
        seen.clear()
        make_batched_solver(hp.make_hkd_fns(), OPTS, fused_lq=hook,
                            fused_riccati=True, **KW)(*args)
        first.append(seen[0])
    names = ("A", "B", "lx", "lu", "lxx", "luu", "lux", "phix_T", "phixx_T",
             "defect", "w", "reg")
    for name, g, w in zip(names, first[1], first[0]):
        _close(g.numpy(), w.numpy(), name)


def test_trial_twin_matches_jax_fallback(plan72):
    """Per scenario against the un-batched `_trial_op` at the plan's dt;
    scenario 1 is not ok in both."""
    d = _operands(*plan72, n_scen=2, seed=5)
    got = _port_trial(plan72[0], d)
    assert got[-1].tolist() == [1.0, 0.0]
    lanes, rest = _jax_trial_args(plan72[0], d)
    N = plan72[0].step.dt.shape[0]
    for b in range(2):
        want = list(jhf._trial_op(*[a[b] for a in lanes], *rest))
        want[1], want[4] = want[1][:N], want[4][:N]   # drop the pad rows
        fields = TRIAL_FIELDS if b == 0 else ("X", "U", "g", "ok")
        for name, g, w in zip(TRIAL_FIELDS, got, want):
            if name in fields:
                _close(g[b], w, f"{name}[{b}]")


def test_trial_twin_matches_pallas_kernel():
    """Against the Pallas kernel in interpret mode, 9 knots at
    dt = 2**-7 (see the module docstring)."""
    plan = _plan(0.06, 8, dt=2.0 ** -7)
    d = _operands(*plan, n_scen=2, seed=6)
    got = _port_trial(plan[0], d)
    lanes, rest = _jax_trial_args(plan[0], d)
    want = list(jax.vmap(jhf._trial_op, in_axes=(0,) * len(lanes)
                         + (None,) * len(rest))(*lanes, *rest))
    N = 8
    want[1], want[4] = want[1][:, :N], want[4][:, :N]
    np.testing.assert_array_equal(np.asarray(want[-1]), [1.0, 0.0])
    for name, g, w in zip(TRIAL_FIELDS, got, want):
        rows = slice(None) if name in ("X", "U", "g", "ok") else slice(0, 1)
        _close(g[rows], np.asarray(w)[rows], name)


def _fused_port_solve(problem):
    plan_np, pen_np, Xbar0, Ubar0, x0 = problem
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), "cpu", torch.float64)
    solve = make_batched_solver(
        hp.make_hkd_fns(), OPTS, fused_forward=hf.make_hkd_fused_forward(),
        fused_lq=hf.make_hkd_fused_lq(), fused_riccati=True, **KW)
    return to_numpy(solve(plan, broadcast_batch(pen, B), x0,
                          broadcast_batch(Xbar0, B),
                          broadcast_batch(Ubar0, B)))


@pytest.fixture(scope="module")
def fused_result(problem):
    return _fused_port_solve(problem)


@pytest.fixture(scope="module")
def jax_fused_result(problem):
    plan_np, pen_np, Xbar0, Ubar0, x0 = problem
    pen = jhp.pen_to_device(pen_np, jnp.float64)
    solve = jax_batched(jhp.make_hkd_fns(), JAX_OPTS, fused_riccati=False,
                        fused_forward=jhf.make_hkd_fused_forward(),
                        fused_lq=jhf.make_hkd_fused_lq(), **KW)
    res = solve(jax_to_device(plan_np, jnp.float64),
                jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                             pen),
                jnp.asarray(x0),
                jnp.broadcast_to(jnp.asarray(Xbar0), (B,) + Xbar0.shape),
                jnp.broadcast_to(jnp.asarray(Ubar0), (B,) + Ubar0.shape))
    return jax.tree.map(np.asarray, res)


# The port's sweep scales the Cholesky diagonal by rsqrt(d) (the Pallas
# sweep's rule) where the JAX un-fused sweep factors exactly: the tolerances
# of test_torch_hkd_solve.py's "pallas" case.  Against the JAX fused solve,
# whose trial kernel rounds dt to float32, the cost also differs by ~5e-8.
@pytest.mark.parametrize("against,x_tol,u_tol,cost_rtol", [
    ("jax_generic", 2e-6, 2e-5, 1e-8),
    ("jax_fused", 2e-6, 2e-5, 1e-7)])
def test_fused_solve_matches_jax(fused_result, request, against, x_tol,
                                 u_tol, cost_rtol):
    want = request.getfixturevalue(
        "jax_result" if against == "jax_generic" else "jax_fused_result")
    got = fused_result
    assert got.success.all() and want.success.all()
    for f in ("iters", "ls_iters", "reg_iters", "n_entries"):
        np.testing.assert_array_equal(getattr(got.info, f),
                                      getattr(want.info, f), err_msg=f)
    np.testing.assert_allclose(got.Xbar, want.Xbar, rtol=0, atol=x_tol)
    np.testing.assert_allclose(got.Ubar, want.Ubar, rtol=0, atol=u_tol)
    np.testing.assert_allclose(got.cost, want.cost, rtol=cost_rtol, atol=0)
    np.testing.assert_allclose(got.max_tconstr, want.max_tconstr, rtol=0,
                               atol=x_tol)

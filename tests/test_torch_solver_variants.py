"""The port's solver variants (`cafempc_tpu_torch/solver/hsddp.py`) against
the JAX package's `make_solver`, f64 on CPU, with the same keywords:

* units on seeded operands (`torch_port_inputs.make_inputs` widths, with
  output-equation terms, transform steps, a scenario at reg 0 and one
  that fails the PSD check): the Riccati LFT elements and their
  composition (1e-12); the port's associative scan against a sequential
  fold and against `jax.lax.associative_scan` over the same composition;
  the sequential exact sweep and the associative-scan sweep stage by
  stage against JAX's, and against each other (equal `ok` flags; G, H, K
  to 1e-9 on the scenarios that pass);
* whole HKD solves on the 0.6 s plan (72 steps) at B=2, 2 AL x 3 DDP,
  reg floor 1e-3: the JAX defaults (masked resets, the exact sweep, the
  scan linear rollout, the batched line search), `parallel_riccati`, the
  sequential linear rollout and line search, and single shooting
  (`opts.MS=False`, `all_shooting=False`).  Xbar and Ubar to atol 1e-7,
  the cost to rtol 1e-9, iteration counts equal (measured: Xbar <= 8.2e-13,
  Ubar <= 4.2e-12, cost <= 3.5e-16 relative);
* the sequential line search's trials, counted in double: a fused
  trial hook that rejects every trial sees eps = 1, 0.1, 0.01 and 0.001
  in float32 as in float64, and in float64 the same trials and
  `ls_iters` as the JAX package's search under that hook;
* the reset cap: a plan with one reset step more than `max_resets` is
  refused in the gathered mode, and solved in the masked mode, which
  agrees with the fused HKD trial's forward pass;
* the MHPC cascade (`SegmentedFns`) of test_torch_mhpc_solve.py under the
  JAX defaults against JAX's `CAFEMPC_WB_LANE=0` path, unchunked and with
  `lq_knot_chunk=5` (which divides neither segment), and the chunked LQ
  equal to the unchunked one;
* every `ValueError` of the JAX make_solver, and `knot_axis` (the knot-
  sharded sweep solving as `parallel_riccati` does).

The barrel roll's masked solve is held to JAX's in
tests/test_torch_barrel_roll.py, beside the JAX solve it already compiles.
"""
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu.parallel.mesh import make_batched_solver as jax_batched
from cafempc_tpu.problems import hkd_fused as jhf
from cafempc_tpu.problems import hkd_problem as jhp
from cafempc_tpu.problems import mhpc_problem as jmp
from cafempc_tpu.solver import hsddp as jhs
from cafempc_tpu.solver.options import SolverOptions as JaxSolverOptions
from cafempc_tpu.solver.plan import host_plan_to_device as jax_to_device
from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.parallel.mesh import (broadcast_batch,
                                             make_batched_solver)
from cafempc_tpu_torch.problems import hkd_fused as hf
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference, synthetic_bound_reference_urdf)
from cafempc_tpu_torch.solver import hsddp
from cafempc_tpu_torch.solver.hsddp import SegmentedFns, make_solver
from cafempc_tpu_torch.solver.options import SolverOptions
from cafempc_tpu_torch.solver.scan import associative_scan
from torch_port_inputs import make_inputs

F64 = torch.float64
UNIT_TOL = 1e-12
SWEEP_TOL = 1e-9


# ---------------------------------------------------------------- units
def _traj(seed, Bsz=3, N=9, xs=6, us=3, ys=2, w_idx=(2, 5, 8)):
    """Seeded TrajState fields (numpy, batch-leading) laid out as the
    solver's LQ stage leaves them: transform steps (reset or padding, w)
    carry only A (their partial) and phix/phixx; dynamics steps carry the
    costs and the output-equation terms C, D, ly, lyy.  Scenario 0 runs
    at reg 0 (a singular luu on the transform steps), scenario 2 fails the
    PSD check at its last dynamics step.  Returns (fields, w, reg)."""
    rng = np.random.default_rng(seed)
    d = make_inputs(rng, Bsz, N, xs, us, w_idx=w_idx, luu_shift=0.5,
                    fail=(2,))
    w = d["w"] > 0
    dyn = (~w)[None, :, None]
    f = dict(A=d["A"], B=d["Bm"] * dyn[..., None], lx=d["lx"] * dyn,
             lu=d["lu"] * dyn, lxx=d["lxx"] * dyn[..., None],
             luu=d["luu"] * dyn[..., None], lux=d["lux"] * dyn[..., None],
             C=rng.normal(size=(Bsz, N, ys, xs)) * 0.2 * dyn[..., None],
             D=rng.normal(size=(Bsz, N, ys, us)) * 0.2 * dyn[..., None],
             ly=rng.normal(size=(Bsz, N, ys)) * 0.3 * dyn,
             Defect=d["defect"])
    M = rng.normal(size=(Bsz, N, ys, ys))
    f["lyy"] = (0.1 * np.einsum("bkij,bkmj->bkim", M, M)
                + 0.1 * np.eye(ys)) * dyn[..., None]
    phix = np.zeros((Bsz, N + 1, xs))
    phixx = np.zeros((Bsz, N + 1, xs, xs))
    phix[:, :-1][:, w] = d["lx"][:, w]
    phixx[:, :-1][:, w] = d["lxx"][:, w]
    phix[:, -1], phixx[:, -1] = d["phix_T"], d["phixx_T"]
    f.update(phix=phix, phixx=phixx,
             Xbar=np.zeros((Bsz, N + 1, xs)), Ubar=np.zeros((Bsz, N, us)))
    reg = d["reg"].copy()
    reg[0] = 0.0
    return f, w, reg


def _port_traj(f):
    z = {k: torch.zeros(1) for k in hsddp.TrajState._fields}
    z.update({k: torch.as_tensor(v) for k, v in f.items()})
    return hsddp.TrajState(**z)


def _jax_traj(f, b):
    z = {k: jnp.zeros(1) for k in jhs.TrajState._fields}
    z.update({k: jnp.asarray(v[b]) for k, v in f.items()})
    return jhs.TrajState(**z)


def _plan(w, module):
    """The plan fields the sweeps read: every flagged step a reset."""
    lib = torch if module == "port" else jnp
    return types.SimpleNamespace(step=types.SimpleNamespace(
        is_reset=lib.asarray(w.astype(float)),
        active=lib.ones(len(w), dtype=lib.float64)))


def _lft_inputs(f, w, reg, lib):
    names = ("A", "B", "C", "D", "lx", "lu", "ly", "lxx", "luu", "lux",
             "lyy", "phix", "phixx", "Defect")
    return [lib.asarray(f[k]) for k in names], lib.asarray(w), \
        lib.asarray(reg)


def test_lft_elements_and_combine_match_jax():
    f, w, reg = _traj(1)
    args, wt, regt = _lft_inputs(f, w, reg, torch)
    got, got_folded = hsddp.riccati_lft_elements(*args, wt, regt)
    for b in range(len(reg)):
        jargs, jw, _ = _lft_inputs({k: v[b] for k, v in f.items()}, w, reg,
                                   jnp)
        want, want_folded = jhs.riccati_lft_elements(*jargs, jw, reg[b])
        for g, x in zip(got + got_folded, want + want_folded):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(x),
                                       rtol=0, atol=UNIT_TOL)
    later = tuple(t[:, 1:] for t in got)
    earlier = tuple(t[:, :-1] for t in got)
    comb = hsddp.lft_combine(later, earlier)
    want = jhs.lft_combine(*[tuple(jnp.asarray(t.numpy()) for t in e)
                             for e in (later, earlier)])
    for g, x in zip(comb, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=0,
                                   atol=UNIT_TOL * max(1.0, float(
                                       np.abs(x).max())))


@pytest.mark.parametrize("N", [1, 2, 3, 6, 9, 16])
def test_associative_scan_matches_fold_and_jax(N):
    """Suffix compositions of LFT elements: the port's scan against the
    fold S_k = combine(S_{k+1}, e_k) and against lax.associative_scan."""
    f, w, reg = _traj(2, N=max(N - 1, 1), w_idx=(0,) if N > 2 else ())
    args, wt, regt = _lft_inputs(f, w, reg, torch)
    elems, _ = hsddp.riccati_lft_elements(*args, wt, regt)
    elems = tuple(e[:, :N] for e in elems)
    got = associative_scan(hsddp.lft_combine, elems, dim=1, reverse=True)
    acc = tuple(e[:, -1] for e in elems)
    fold = [acc]
    for k in reversed(range(N - 1)):
        acc = hsddp.lft_combine(acc, tuple(e[:, k] for e in elems))
        fold.append(acc)
    fold = [torch.stack(parts[::-1], 1) for parts in zip(*fold)]
    for b in range(len(reg)):
        want = jax.lax.associative_scan(
            jhs.lft_combine, tuple(jnp.asarray(e[b].numpy()) for e in elems),
            reverse=True)
        for g, x in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(x), rtol=0,
                                       atol=UNIT_TOL * max(1.0, float(
                                           np.abs(x).max())))
    for g, x in zip(got, fold):
        scale = max(1.0, float(x.abs().max()))
        assert float((g - x).abs().max()) <= 1e-10 * scale


def test_associative_scan_forward_products_match_jax():
    """A non-commutative forward scan, the linear rollout's composition."""
    rng = np.random.default_rng(3)
    M = rng.normal(size=(2, 11, 4, 4)) * 0.5
    c = rng.normal(size=(2, 11, 4))

    def comb_t(a, b):
        return (b[0] @ a[0], (b[0] @ a[1][..., None])[..., 0] + b[1])

    def comb_j(a, b):
        return (jnp.einsum("kij,kjl->kil", b[0], a[0]),
                jnp.einsum("kij,kj->ki", b[0], a[1]) + b[1])

    got = associative_scan(comb_t, (torch.as_tensor(M), torch.as_tensor(c)),
                           dim=1)
    for b in range(2):
        want = jax.lax.associative_scan(comb_j, (jnp.asarray(M[b]),
                                                 jnp.asarray(c[b])))
        for g, x in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(x), rtol=0,
                                       atol=UNIT_TOL)


def _sweep_outputs(outs, module):
    if module == "port":
        (G, H, K, dU, Qu, Quu, Qux), dV1, dV2, ok = outs
        return [t.numpy() for t in (G, H, K, dU, Qu, Quu, Qux, dV1, dV2,
                                    ok)]
    tr, dV1, dV2, ok = outs
    return [np.asarray(t) for t in (tr.G, tr.H, tr.K, tr.dU, tr.Qu, tr.Quu,
                                    tr.Qux, dV1, dV2, ok)]


@pytest.mark.parametrize("stage", ["_backward_sweep",
                                   "_backward_sweep_parallel"])
def test_sweep_stage_matches_jax(stage):
    """The exact sequential sweep and the associative-scan sweep, each
    against JAX's stage of the same name, scenario by scenario."""
    f, w, reg = _traj(4)
    port = getattr(make_solver(hp.make_hkd_fns(), SolverOptions()), stage)
    jax_stage = getattr(jhs.make_solver(jhp.make_hkd_fns(),
                                        JaxSolverOptions()), stage)
    got = _sweep_outputs(port(_plan(w, "port"), _port_traj(f),
                              torch.as_tensor(reg)), "port")
    assert got[-1].tolist() == [True, True, False]
    for b in range(len(reg)):
        want = _sweep_outputs(jax_stage(_plan(w, "jax"), _jax_traj(f, b),
                                        jnp.asarray(reg[b])), "jax")
        assert got[-1][b] == want[-1]
        if not want[-1]:
            continue
        for g, x in zip(got[:-1], want[:-1]):
            scale = max(1.0, float(np.abs(x).max()))
            np.testing.assert_allclose(g[b], x, rtol=0,
                                       atol=1e-10 * scale)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_parallel_sweep_matches_sequential_sweep(seed):
    f, w, reg = _traj(seed)
    solve = make_solver(hp.make_hkd_fns(), SolverOptions())
    plan, tr, regt = _plan(w, "port"), _port_traj(f), torch.as_tensor(reg)
    seq = _sweep_outputs(solve._backward_sweep(plan, tr, regt), "port")
    par = _sweep_outputs(solve._backward_sweep_parallel(plan, tr, regt),
                         "port")
    np.testing.assert_array_equal(seq[-1], par[-1])
    ok = seq[-1]
    assert ok.tolist() == [True, True, False]
    for g, x in zip(par[:3], seq[:3]):    # G, H, K
        scale = max(1.0, float(np.abs(x[ok]).max()))
        assert float(np.abs(g[ok] - x[ok]).max()) <= SWEEP_TOL * scale


# ------------------------------------------------------- whole solves
B = 2
OPTS = dict(max_AL_iter=2, max_DDP_iter=3)


def _hkd_problem(plan_duration=0.6, n_steps=72):
    qr = QuadReference(synthetic_bound_reference(duration=2.0))
    qr.initialize(plan_duration)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(
        qr, hp.HKDConfig(plan_duration=plan_duration, n_steps_max=n_steps))
    x0 = Xbar0[0][None] + np.random.default_rng(5).normal(0, 0.01, (B, 24))
    return plan_np, pen_np, Xbar0, Ubar0, x0


@pytest.fixture(scope="module")
def hkd():
    return _hkd_problem()


def _port_args(problem):
    plan_np, pen_np, Xbar0, Ubar0, x0 = problem
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), "cpu", F64)
    return (plan, broadcast_batch(pen, B), x0, broadcast_batch(Xbar0, B),
            broadcast_batch(Ubar0, B))


def _jax_args(problem):
    plan_np, pen_np, Xbar0, Ubar0, x0 = problem

    def batch(a):
        a = jnp.asarray(np.asarray(a), jnp.float64)
        return jnp.broadcast_to(a, (B,) + a.shape)

    return (jax_to_device(plan_np, dtype=jnp.float64),
            jax.tree.map(batch, pen_np), jnp.asarray(x0), batch(Xbar0),
            batch(Ubar0))


def _assert_same_solve(got, want, x_tol=1e-7, cost_rtol=1e-9):
    np.testing.assert_array_equal(got.success, want.success)
    assert got.success.all()
    for f in ("iters", "ls_iters", "reg_iters", "n_entries"):
        np.testing.assert_array_equal(getattr(got.info, f),
                                      getattr(want.info, f), err_msg=f)
    np.testing.assert_allclose(got.Xbar, want.Xbar, rtol=0, atol=x_tol)
    np.testing.assert_allclose(got.Ubar, want.Ubar, rtol=0, atol=x_tol)
    np.testing.assert_allclose(got.cost, want.cost, rtol=cost_rtol, atol=0)
    np.testing.assert_allclose(got.info.cost_buf, want.info.cost_buf,
                               rtol=cost_rtol, atol=0)


HKD_CASES = {
    "jax-defaults": dict(),
    "parallel-riccati": dict(parallel_riccati=True),
    "sequential-linroll-and-line-search": dict(
        parallel_linear_rollout=False, parallel_line_search=False),
    "single-shooting": dict(all_shooting=False, MS=False),
}


@pytest.mark.parametrize("case", sorted(HKD_CASES))
def test_hkd_solve_matches_jax(hkd, case):
    kw = dict(HKD_CASES[case])
    opts = dict(OPTS, MS=kw.pop("MS", True))
    want = jax_batched(jhp.make_hkd_fns(), JaxSolverOptions(**opts),
                       trim_output=True, reg_floor=1e-3, **kw)(
        *_jax_args(hkd))
    got = make_batched_solver(hp.make_hkd_fns(), SolverOptions(**opts),
                              reg_floor=1e-3, **kw)(*_port_args(hkd))
    _assert_same_solve(to_numpy(got), jax.tree.map(np.asarray, want))




def _jax_rejected_trials(problem):
    """The JAX package's f64 sequential search under a fused trial hook
    that rejects every trial, one unbatched solve a scenario (so the
    hook's trial op takes its plain JAX fallback): the eps of each
    line-search trial, and `ls_iters`."""
    plan_np, pen_np, Xbar0, Ubar0, x0 = problem
    real, seen = jhf.make_hkd_fused_forward(), []

    def rejecting(plan, pen, tr, x0, eps):
        jax.debug.callback(lambda e: seen.append(float(e)), eps,
                           ordered=True)
        out = real(plan, pen, tr, x0, eps)
        return out[:-1] + (jnp.zeros_like(out[-1]),)
    solve = jax.jit(jhs.make_solver(
        jhp.make_hkd_fns(), JaxSolverOptions(max_AL_iter=1, max_DDP_iter=1),
        fused_forward=rejecting, parallel_line_search=False,
        reg_floor=1e-3, trim_output=True))
    args = _jax_args(problem)
    eps, ls_iters = [], []
    for b in range(B):
        seen.clear()
        res = solve(args[0], jax.tree.map(lambda a: a[b], args[1]),
                    args[2][b], args[3][b], args[4][b])
        jax.effects_barrier()
        eps.append([e for e in seen if e > 0])    # 0: the first rollout
        ls_iters.append(int(res.info.ls_iters))
    return eps, ls_iters


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sequential_line_search_steps_eps_in_double(hkd, dtype):
    """A fused forward hook that rejects every trial of the line search:
    the sequential search visits eps = 1, 0.1, 0.01 and 0.001, as the
    reference's double loop does at the default alpha and ls_eps_min,
    in float32 as in float64 (in float32, 0.1**3 rounds to
    float32(1e-3), and a test of eps itself would stop at 0.01).  In
    float64 the trials and `ls_iters` equal the JAX package's search
    under the same hook."""
    dt = getattr(torch, dtype)
    plan_np, pen_np, Xbar0, Ubar0, x0 = hkd
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), "cpu", dt)
    real, seen = hf.make_hkd_fused_forward(), []

    def rejecting(plan, pen, tr, x0, eps, plain_ops=False):
        out = real(plan, pen, tr, x0, eps, plain_ops=plain_ops)
        eps = torch.as_tensor(eps, dtype=dt).expand(x0.shape[0])
        if not (eps > 0).any():
            return out
        seen.append(eps.tolist())
        return out[:-1] + (torch.zeros_like(out[-1]),)
    solve = make_solver(hp.make_hkd_fns(),
                        SolverOptions(max_AL_iter=1, max_DDP_iter=1),
                        fused_forward=rejecting, parallel_line_search=False,
                        reg_floor=1e-3, plain_ops=True)
    res = solve(plan, broadcast_batch(pen, B), x0, broadcast_batch(Xbar0, B),
                broadcast_batch(Ubar0, B))
    assert hsddp._n_steps(SolverOptions(), 0.0) == 4
    np.testing.assert_allclose(seen, [[e] * B for e in (1, 0.1, 0.01, 1e-3)],
                               rtol=1e-6)
    assert res.info.ls_iters.tolist() == [4] * B
    if dt == F64:
        want_eps, want_ls = _jax_rejected_trials(hkd)
        np.testing.assert_array_equal(np.transpose(seen), want_eps)
        assert res.info.ls_iters.tolist() == want_ls


def test_reset_cap_raises_and_masked_resets_match_fused_trial(hkd):
    """A plan with max_resets + 1 reset steps: the gathered mode refuses
    it; the masked mode solves it, and agrees with the solve whose every
    forward pass is the fused HKD trial (which applies every reset)."""
    args = _port_args(hkd)
    n_reset = int(args[0].step.is_reset.sum())
    assert n_reset >= 2
    opts = SolverOptions(**OPTS)
    kw = dict(parallel_line_search=False, reg_floor=1e-3)
    with pytest.raises(ValueError, match=f"{n_reset} reset steps, more "
                                         f"than max_resets={n_reset - 1}"):
        make_solver(hp.make_hkd_fns(), opts, max_resets=n_reset - 1,
                    **kw)(*args)
    masked = make_solver(hp.make_hkd_fns(), opts, **kw)
    fused = make_solver(hp.make_hkd_fns(), opts,
                        fused_forward=hf.make_hkd_fused_forward(), **kw)
    got, want = to_numpy(masked(*args)), to_numpy(fused(*args))
    _assert_same_solve(got, want)
    # one forward pass on the solved trajectory with a seeded direction
    plan, pen, x0 = args[:3]
    tr = hsddp.init_traj(plan, 24, 24, plan.step.y_ref.shape[-1],
                         torch.as_tensor(got.Xbar), torch.as_tensor(got.Ubar))
    gen = torch.Generator().manual_seed(0)
    tr = tr._replace(dX=0.01 * torch.randn(tr.dX.shape, generator=gen,
                                           dtype=F64),
                     dU=0.1 * torch.randn(tr.dU.shape, generator=gen,
                                          dtype=F64))
    eps = torch.tensor([1.0, 0.3], dtype=F64)
    roll, ok = masked._rollout(plan, None, tr, x0, eps)
    f_tr = hf.make_hkd_fused_forward()(plan, pen, tr, x0, eps,
                                      plain_ops=True)[0]
    for k in ("X", "U", "Xsim", "Defect"):
        np.testing.assert_allclose(getattr(roll, k).numpy(),
                                   getattr(f_tr, k).numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)


# ------------------------------------------------------------- MHPC
MHPC_PLAN = dict(plan_dur_wb=0.1, plan_dur_srb=0.2, n_steps_max=24,
                 wb_block=16)
MHPC_OPTS = dict(max_AL_iter=2, max_DDP_iter=1)


@pytest.fixture(scope="module")
def mhpc(tmp_path_factory):
    urdf = synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(0.4)
    cfg = mp.MHPCConfig(**MHPC_PLAN)
    plan_np, pen_np, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, cfg)
    x0 = wb_state_ref_at(qr, 0.0)[None] \
        + np.random.default_rng(3).normal(0, 0.01, (B, mp.XS))
    return urdf, cfg, (plan_np, pen_np, Xbar0, Ubar0, x0)


@pytest.fixture(scope="module")
def mhpc_jax_result(mhpc):
    urdf, cfg, problem = mhpc
    mpatch = pytest.MonkeyPatch()
    mpatch.setenv("CAFEMPC_WB_LANE", "0")
    try:
        fns = jmp.make_mhpc_fns_segmented(jmp.MHPCConfig(**vars(cfg)),
                                          jwbm.load_model(urdf), urdf=urdf)
    finally:
        mpatch.undo()
    res = jax_batched(fns, JaxSolverOptions(**MHPC_OPTS), trim_output=True,
                      reg_floor=1e-3)(*_jax_args(problem))
    return jax.tree.map(np.asarray, res)


def _mhpc_fns(mhpc):
    urdf, cfg, _ = mhpc
    return mp.make_mhpc_fns_segmented(cfg, wbm.load_model(urdf, "cpu", F64))


@pytest.mark.parametrize("chunk", [None, 5])
def test_mhpc_solve_matches_jax(mhpc, mhpc_jax_result, chunk):
    """The segmented cascade under the JAX defaults (masked resets per
    segment, the batched line search, the exact sweep, the scan linear
    rollout); lq_knot_chunk=5 splits the 16 WB and 8 SRB steps unevenly."""
    plan_np = mhpc[2][0]
    assert int(plan_np.step.is_reset.sum()) == 6
    got = make_batched_solver(_mhpc_fns(mhpc), SolverOptions(**MHPC_OPTS),
                              reg_floor=1e-3, lq_knot_chunk=chunk)(
        *_port_args(mhpc[2]))
    _assert_same_solve(to_numpy(got), mhpc_jax_result)


def test_chunked_lq_equals_unchunked(mhpc):
    fns = _mhpc_fns(mhpc)
    args = _port_args(mhpc[2])
    plan = args[0]
    tr = hsddp.init_traj(plan, mp.XS, mp.US, mp.YS, args[3], args[4])
    tr = tr._replace(X=args[3], U=args[4])
    opts = SolverOptions()
    want = make_solver(fns, opts)._lq_approx(plan, None, args[1], tr)
    got = make_solver(fns, opts, lq_knot_chunk=5)._lq_approx(
        plan, None, args[1], tr)
    for name in ("A", "B", "C", "D", "lx", "lu", "ly", "lxx", "luu", "lux",
                 "lyy", "phix", "phixx"):
        g, w = getattr(got, name), getattr(want, name)
        assert float((g - w).abs().max()) <= 1e-13 * max(
            1.0, float(w.abs().max())), name


# ----------------------------------------------------------- errors
# (make_solver keywords, SolverOptions fields, SegmentedFns?, message)
ERRORS = {
    "knot-shards": (dict(knot_axis="knot", knot_shards=1), {}, False,
                    "knot_shards >= 2"),
    "fused-forward-parallel-line-search": (
        dict(fused_forward=lambda *a, **k: None), {}, False,
        "fused_forward"),
    "fused-forward-single-shooting": (
        dict(fused_forward=lambda *a, **k: None, parallel_line_search=False,
             all_shooting=False), {}, False, "fused_forward"),
    "fused-forward-MS-off": (
        dict(fused_forward=lambda *a, **k: None, parallel_line_search=False),
        dict(MS=False), False, "fused_forward"),
    "fused-lq-chunk": (dict(fused_lq=lambda *a, **k: None, lq_knot_chunk=8),
                       {}, False, "mutually exclusive"),
    "segmented-single-shooting": (dict(all_shooting=False), {}, True,
                                  "SegmentedFns"),
    "segmented-MS-off": (dict(), dict(MS=False), True, "SegmentedFns"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_make_solver_raises_as_jax_does(case):
    kw, opts, segmented, match = ERRORS[case]
    fns, jfns = hp.make_hkd_fns(), jhp.make_hkd_fns()
    if segmented:
        fns = SegmentedFns(counts=(1, 1), fns=(fns, fns))
        jfns = jhs.SegmentedFns(counts=(1, 1), fns=(jfns, jfns))
    with pytest.raises(ValueError, match=match):
        jhs.make_solver(jfns, JaxSolverOptions(**opts), **kw)
    with pytest.raises(ValueError, match=match):
        make_solver(fns, SolverOptions(**opts), **kw)


def test_knot_axis_is_not_ported(hkd):
    """The knot-sharded sweep is ported: knot_axis with fused_riccati raises
    (the JAX package lets knot_axis silently replace the kernel), and
    without it the HKD solve over 3 knot blocks is the parallel_riccati
    solve (which test_hkd_solve_matches_jax holds to JAX's)."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_solver(hp.make_hkd_fns(), SolverOptions(), knot_axis="knot",
                    knot_shards=2, fused_riccati=True)
    opts = SolverOptions(**OPTS)
    want = make_batched_solver(hp.make_hkd_fns(), opts, reg_floor=1e-3,
                               parallel_riccati=True)(*_port_args(hkd))
    got = make_batched_solver(hp.make_hkd_fns(), opts, reg_floor=1e-3,
                              knot_axis="knot", knot_shards=3)(
        *_port_args(hkd))
    _assert_same_solve(to_numpy(got), to_numpy(want))


def test_defaults_are_jax_defaults():
    """make_solver and make_batched_solver take every keyword of their JAX
    counterparts with the JAX default, trim_output excepted."""
    for port_fn, jax_fn in ((make_solver, jhs.make_solver),
                            (make_batched_solver, jax_batched)):
        got = inspect.signature(port_fn).parameters
        for name, p in inspect.signature(jax_fn).parameters.items():
            if p.kind is p.KEYWORD_ONLY and name != "trim_output":
                assert name in got, name
                assert got[name].default == p.default, name

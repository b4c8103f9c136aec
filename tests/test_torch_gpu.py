"""The CUDA kernels on the card: each against its plain twin, and a small
HKD solve through the kernels against the same solve through the twins;
small HKD solves under the JAX package's default configuration and the
solver's other plain-PyTorch stages on the card against the CPU;
the whole-body and SRB model layer (the closed-form-bundle partials
included) and the HKD model's AD partials on the card against the CPU; the MHPC cascade's WB functions on
the card against the CPU, small MHPC solves (segmented and joint mode)
through the sweep and linroll kernels against the same solves through
their twins, and a small HKD runtime served over an in-memory transport
launching the sweep and linroll kernels on every solve.

Every test here needs a CUDA device and skips without one.  The file
imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.models import hkd, srb, synthetic_robot, wb_lane, wbm
from cafempc_tpu_torch.ops import hkd_lq as hl
from cafempc_tpu_torch.ops import hkd_trial as ht
from cafempc_tpu_torch.ops import linroll as lr
from cafempc_tpu_torch.ops import sweep as sw
from cafempc_tpu_torch.parallel.mesh import broadcast_batch
from cafempc_tpu_torch.problems import hkd_fused as hf
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference, synthetic_bound_reference_urdf)
from cafempc_tpu_torch.solver import hsddp
from cafempc_tpu_torch.solver.hsddp import make_solver
from cafempc_tpu_torch.solver.options import SolverOptions
from torch_port_inputs import (HKD_LQ_IN, HKD_TRIAL_IN, hkd_operands,
                               make_inputs)

# (dtype, tolerance on the error normalized by the twin's max |value|):
# float32 sums in another order than the twin's batched matmuls
DTYPES = [(torch.float32, 1e-4), (torch.float64, 1e-10)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def _shifted(t):
    """A copy of t that starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _hkd_plan(duration=0.3, n_steps=40, ref_duration=1.0):
    """A plan on the synthetic bound reference; by default the 0.3 s plan
    (40 steps: resets and padding)."""
    qr = QuadReference(synthetic_bound_reference(duration=ref_duration))
    qr.initialize(duration)
    return hp.build_hkd_plan(qr, hp.HKDConfig(plan_duration=duration,
                                              n_steps_max=n_steps))


# (B, N, xs, us): a small batch, the runtime's single scenario over the
# bench plan's 112 knots, and the MHPC widths at an odd batch and length
SWEEP_SHAPES = [(8, 16, 24, 24), (1, 112, 24, 24), (37, 33, 36, 12)]


def _sweep_operands(cuda, dtype, Bsz, N, xs, us, fail=()):
    d = make_inputs(np.random.default_rng(13), Bsz, N, xs, us,
                    w_idx=(3, 7), luu_shift=1.0, fail=fail)
    t = [torch.as_tensor(d[k], device=cuda, dtype=dtype) for k in (
        "A", "Bm", "lx", "lu", "lxx", "luu", "lux", "phix_T", "phixx_T",
        "defect")]
    return (*t, torch.as_tensor(d["w"], device=cuda),
            torch.as_tensor(d["reg"], device=cuda, dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_sweep_kernel_matches_twin(cuda, shape, dtype, tol):
    """Kernel against twin with every scenario ok, then with scenario
    B // 2 failing the PSD check at one dynamics step: identical `ok`
    flags, and the values of every ok scenario within tol."""
    Bsz, N, xs, us = shape
    before = sw.sweep.launches
    for fail in ((), (Bsz // 2,)):
        args = _sweep_operands(cuda, dtype, Bsz, N, xs, us, fail)
        got = sw.sweep(*args)
        want = sw.sweep_reference(*args)
        torch.cuda.synchronize()
        ok = want[7] > 0.5
        assert ok.tolist() == [b not in fail for b in range(Bsz)]
        assert torch.equal(got[7] > 0.5, ok)
        if not bool(ok.any()):
            continue
        for i in (0, 1, 2, 3, 4, 5, 6, 8):  # G, H, K, dU, Qu, Quu, Qux, dv
            assert _rel_err(got[i][ok], want[i][ok]) < tol
    assert sw.sweep.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [d for d, _ in DTYPES])
def test_sweep_kernel_refuses_rows_not_16_byte_multiples(cuda, dtype):
    """xs=6, us=3: rows of 24 or 12 bytes, which the kernel's bulk copies
    cannot move; the wrapper raises and counts no launch."""
    args = _sweep_operands(cuda, dtype, 5, 9, 6, 3)
    before = sw.sweep.launches
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        sw.sweep(*args)
    assert sw.sweep.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [d for d, _ in DTYPES])
def test_sweep_kernel_copies_misaligned_operands(cuda, dtype):
    """Operands that start one element past a 16-byte boundary give the
    same results as aligned ones: the wrapper copies them."""
    args = _sweep_operands(cuda, dtype, 4, 12, 24, 24)
    moved = [_shifted(t) if t.is_floating_point() else t for t in args]
    assert moved[0].data_ptr() % 16 != 0
    got = sw.sweep(*moved)
    want = sw.sweep(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (B, N, xs): a small batch, the runtime's single scenario over the bench
# plan's 112 knots, the MHPC width at an odd batch and length, and plans
# shorter than one stage of the kernel's ring (8 knots at xs=24)
LINROLL_SHAPES = [(8, 40, 24), (1, 112, 24), (37, 33, 36), (5, 1, 24),
                  (5, 3, 24)]


def _linroll_operands(cuda, dtype, Bsz, N, xs):
    """Seeded operands whose N-step products stay bounded."""
    rng = np.random.default_rng(23)
    return tuple(torch.as_tensor(a, device=cuda, dtype=dtype) for a in (
        rng.normal(size=(Bsz, N, xs, xs)) * 0.8 / np.sqrt(xs),
        rng.normal(size=(Bsz, N, xs)) * 0.1, rng.normal(size=(Bsz, xs))))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", LINROLL_SHAPES)
def test_linroll_kernel_matches_twin(cuda, shape, dtype, tol):
    M, c, dx0 = _linroll_operands(cuda, dtype, *shape)
    before = lr.linroll.launches
    got = lr.linroll(M, c, dx0)
    want = lr.linroll_reference(M, c, dx0)
    torch.cuda.synchronize()
    assert lr.linroll.launches == before + 1
    assert got.shape == want.shape
    assert _rel_err(got, want) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [d for d, _ in DTYPES])
def test_linroll_kernel_copies_misaligned_operands(cuda, dtype):
    """Operands that start one element past a 16-byte boundary give
    results bit-identical to aligned ones: the wrapper copies them."""
    args = _linroll_operands(cuda, dtype, 6, 20, 24)
    moved = [_shifted(t) for t in args]
    assert all(t.data_ptr() % 16 != 0 for t in moved)
    got = lr.linroll(*moved)
    want = lr.linroll(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_linroll_kernel_keeps_non_finite_scenarios_apart(cuda, dtype, tol):
    """inf in one scenario's M and NaN in another's c: the same scenarios
    are non-finite in kernel and twin, and every other scenario agrees
    within tol."""
    Bsz, N = 7, 40
    M, c, dx0 = _linroll_operands(cuda, dtype, Bsz, N, 24)
    M[2, N // 2, 5, 7] = float("inf")
    c[4, 11, 3] = float("nan")
    got = lr.linroll(M, c, dx0)
    want = lr.linroll_reference(M, c, dx0)
    torch.cuda.synchronize()
    finite = torch.isfinite(want).flatten(1).all(1)
    assert finite.tolist() == [b not in (2, 4) for b in range(Bsz)]
    assert torch.equal(torch.isfinite(got).flatten(1).all(1), finite)
    assert _rel_err(got[finite], want[finite]) < tol


@pytest.mark.gpu
def test_kernels_refuse_other_dtypes(cuda):
    m = torch.zeros(2, 3, 4, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        lr.linroll(m, torch.zeros(2, 3, 4, device=cuda, dtype=m.dtype),
                   torch.zeros(2, 4, device=cuda, dtype=m.dtype))


HKD_OPS = {"hkd_lq": (hl.hkd_lq, hl.hkd_lq_reference, HKD_LQ_IN),
           "hkd_trial": (ht.hkd_trial, ht.hkd_trial_reference, HKD_TRIAL_IN)}

# (plan seconds, steps, reference seconds, B): the 40-step plan at B=8;
# the bench plan's 112 steps at an odd batch; 170 steps, past the 128
# knots of one trial CTA, so its last pass over the knots is ragged (and
# 41, 113 and 171 knots are not multiples of a warp's 8 knots)
HKD_CASES = [(0.3, 40, 1.0, 8), (1.0, 112, 2.0, 37), (1.4, 170, 2.4, 5)]


def _hkd_args(cuda, op, dtype, case):
    """Seeded operands of one HKD kernel; the trial blows up scenario 1
    (dX 1e7 at knot 3), 2 (inf) and the last (nan), so that those are not
    ok.  Returns the arguments and the blown-up scenarios."""
    seconds, n_steps, ref_seconds, Bsz = case
    plan_np, pen_np, Xbar0, Ubar0, _ = _hkd_plan(seconds, n_steps,
                                                 ref_seconds)
    d = hkd_operands(plan_np, pen_np, Xbar0, Ubar0, Bsz, seed=31)
    d["dX"][2, 5, 7] = np.inf
    d["dX"][Bsz - 1, 2, 0] = np.nan
    table = hf.knot_table(from_numpy(plan_np, cuda, dtype))
    args = [torch.as_tensor(d[k], device=cuda, dtype=dtype)
            for k in HKD_OPS[op][2]] + [table, hp.MU_FRIC]
    return args, (1, 2, Bsz - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", HKD_CASES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("op", sorted(HKD_OPS))
def test_hkd_kernel_matches_twin(cuda, op, dtype, tol, case):
    """The fused HKD LQ and trial kernels against their twins; the trial's
    blown-up scenarios (1e7, inf, nan in dX) are not ok in both, and the
    values of the others are compared."""
    fn, twin, _ = HKD_OPS[op]
    args, blown = _hkd_args(cuda, op, dtype, case)
    Bsz = case[-1]
    before = fn.launches
    got = fn(*args)
    want = twin(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    keep = slice(None)
    if op == "hkd_trial":
        assert torch.equal(got[-1], want[-1])
        keep = want[-1] > 0.5
        assert keep.tolist() == [b not in blown for b in range(Bsz)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g[keep], w[keep]) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [d for d, _ in DTYPES])
@pytest.mark.parametrize("op", sorted(HKD_OPS))
def test_hkd_kernel_copies_misaligned_operands(cuda, op, dtype):
    """Operands that start one element past a 16-byte boundary give the
    same results as aligned ones (the trial's wrapper copies them, since
    its kernel moves rows 16 bytes at a time)."""
    fn = HKD_OPS[op][0]
    args, _ = _hkd_args(cuda, op, dtype, HKD_CASES[0])
    moved = [_shifted(t) if torch.is_tensor(t) else t for t in args]
    assert all(t.data_ptr() % 16 != 0 for t in moved if torch.is_tensor(t))
    got = fn(*moved)
    want = fn(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(), w.nan_to_num())


def _solve_args(cuda):
    plan_np, pen_np, Xbar0, Ubar0, meta = _hkd_plan()
    f64 = torch.float64
    body = torch.zeros(12, dtype=f64)
    body[5] = 0.2486
    qd = hkd.compute_hkd_state(
        body[0:3], body[3:6], torch.tensor([0.0, -0.8, 1.6] * 4, dtype=f64),
        torch.tensor(meta["phases"][0][3], dtype=f64))
    x0 = torch.cat([body, qd])[None] + 0.01 * torch.as_tensor(
        np.random.default_rng(7).normal(size=(4, 24)))
    plan, pen, Xbar0, Ubar0 = from_numpy((plan_np, pen_np, Xbar0, Ubar0),
                                         cuda, f64)
    return (plan, broadcast_batch(pen, 4), x0.to(cuda),
            broadcast_batch(Xbar0, 4), broadcast_batch(Ubar0, 4))


def _same_solve(got, want):
    assert bool(got.success.all())
    for f in ("iters", "ls_iters", "reg_iters"):
        assert torch.equal(getattr(got.info, f), getattr(want.info, f))
    for f in ("Xbar", "Ubar"):
        assert float((getattr(got, f) - getattr(want, f)).abs().max()) < 1e-8
    assert float(((got.cost - want.cost) / want.cost).abs().max()) < 1e-10


@pytest.mark.gpu
def test_solve_through_kernels_matches_twins(cuda):
    """A B=4 f64 solve of a 0.3 s plan: kernels against twins, same
    iteration counts, trajectories to 1e-8."""
    args = _solve_args(cuda)
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=2)
    kw = dict(fused_riccati=True, parallel_line_search=False,
              max_resets=16, reg_floor=1e-3)
    before = (sw.sweep.launches, lr.linroll.launches)
    got = make_solver(hp.make_hkd_fns(), opts, **kw)(*args)
    torch.cuda.synchronize()
    assert sw.sweep.launches > before[0]
    assert lr.linroll.launches > before[1]
    want = make_solver(hp.make_hkd_fns(), opts, plain_ops=True, **kw)(*args)
    _same_solve(got, want)


# make_solver configurations with no kernel on their path (the JAX
# package's defaults and the other plain stages), keywords and SolverOptions
PLAIN_SOLVES = {
    "jax-defaults": ({}, {}),
    "parallel-riccati": (dict(parallel_riccati=True), {}),
    "sequential-stages": (dict(parallel_linear_rollout=False,
                               parallel_line_search=False), {}),
    "single-shooting": (dict(all_shooting=False), dict(MS=False)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(PLAIN_SOLVES))
def test_plain_stage_solve_on_card_matches_cpu(cuda, case):
    """A B=4 f64 solve of a 0.3 s plan under the JAX defaults (masked
    resets, exact sweep, scan linear rollout, batched line search) and
    the other plain-PyTorch stages, on the card against the CPU: same
    iteration counts, trajectories to 1e-8; no kernel launches."""
    kw, opts = PLAIN_SOLVES[case]
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=2, **opts)
    args = _solve_args(cuda)
    fns = (sw.sweep, lr.linroll)
    before = [f.launches for f in fns]
    got = make_solver(hp.make_hkd_fns(), opts, reg_floor=1e-3, **kw)(*args)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == before
    want = make_solver(hp.make_hkd_fns(), opts, reg_floor=1e-3, **kw)(
        *_solve_args(torch.device("cpu")))
    _same_solve(from_numpy(to_numpy(got), "cpu", torch.float64), want)


@pytest.mark.gpu
def test_solve_through_all_four_kernels_matches_twins(cuda):
    """The `hkd` bench default's path (fused LQ and trial hooks) at B=4,
    f64: through all four kernels against all four twins, same iteration
    counts, trajectories to 1e-8; the twin solve launches no kernel."""
    args = _solve_args(cuda)
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=2)
    kw = dict(fused_riccati=True, parallel_line_search=False,
              max_resets=16, reg_floor=1e-3)
    fns = (sw.sweep, lr.linroll, hl.hkd_lq, ht.hkd_trial)

    def solver(plain_ops):
        return make_solver(hp.make_hkd_fns(), opts, plain_ops=plain_ops,
                           fused_forward=hf.make_hkd_fused_forward(),
                           fused_lq=hf.make_hkd_fused_lq(), **kw)

    before = [f.launches for f in fns]
    got = solver(False)(*args)
    torch.cuda.synchronize()
    after = [f.launches for f in fns]
    assert all(a > b for a, b in zip(after, before))
    want = solver(True)(*args)
    assert [f.launches for f in fns] == after
    _same_solve(got, want)


# ---- the whole-body and SRB model layer (plain PyTorch) ---------------

def _wb_knots(n, seed=41):
    rng = np.random.default_rng(seed)
    q = np.zeros((n, 18))
    q[:, 2] = 0.25 + rng.normal(0, 0.05, n)
    q[:, 3:6] = rng.normal(0, 0.3, (n, 3))
    q[:, 6:] = np.tile([0.0, -0.8, 1.6], 4) + rng.normal(0, 0.3, (n, 12))
    return dict(x=np.concatenate([q, rng.normal(0, 1.0, (n, 18))], 1),
                u=rng.normal(0, 5.0, (n, 12)), dt=np.full(n, 0.01),
                c=(rng.random((n, 4)) > 0.4).astype(float))


def _srb_knots(n, seed=43):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(0, 0.3, (n, 12)), u=rng.normal(0, 30.0, (n, 12)),
                pf=rng.normal(0, 0.2, (n, 12)),
                c=(rng.random((n, 4)) > 0.4).astype(float))


def _on(d, device, dtype):
    return {k: torch.as_tensor(a, device=device, dtype=dtype)
            for k, a in d.items()}


@pytest.fixture(scope="module")
def robot(tmp_path_factory):
    return synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))


def _wb_partials(device, dtype, robot, d):
    m = wb_lane.load_lane_model(robot, device, dtype)
    d = _on(d, device, dtype)
    return (*wb_lane.wb_dyn_partials_lane(m, d["x"], d["u"], d["dt"],
                                          d["c"], 10.0),
            *wb_lane.impulse_dynamics_partials_lane(m, d["x"][:, :18],
                                                    d["x"][:, 18:], d["c"]))


def _srb_partials(device, dtype, d):
    d = _on(d, device, dtype)
    return srb.dynamics_partials(d["x"], d["u"], d["pf"], d["c"], 0.02)


# (dtype, tolerance on the card's error normalized by the CPU f64 result's
# max |value|): f32 against f64 loses what the KKT's conditioning costs
MODEL_DTYPES = [(torch.float32, 1e-3), (torch.float64, 1e-10)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", MODEL_DTYPES)
def test_wb_partials_on_card_match_cpu(cuda, robot, dtype, tol):
    """The WB linearization (A, B, C, D) and the impulse partials of 16
    knots on the card against the same knots in f64 on the CPU."""
    d = _wb_knots(16)
    got = _wb_partials(cuda, dtype, robot, d)
    want = _wb_partials("cpu", torch.float64, robot, d)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == dtype
        assert bool(torch.isfinite(g).all())
        assert _rel_err(g.cpu().double(), w) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_srb_partials_on_card_match_cpu(cuda, dtype, tol):
    d = _srb_knots(32)
    for g, w in zip(_srb_partials(cuda, dtype, d),
                    _srb_partials("cpu", torch.float64, d)):
        assert g.device.type == "cuda" and g.dtype == dtype
        assert _rel_err(g.cpu().double(), w) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_hkd_ad_partials_on_card_match_cpu(cuda, dtype, tol):
    """`dynamics_partials_ad` and `reset_map_partial_ad` (the JAX
    package's AD route) on [4, 16] knots against [16] plan
    data on the card, against the same knots in f64 on the CPU and against
    the closed forms on the card."""
    r = np.random.default_rng(3)
    x = r.uniform(-1.0, 1.0, (4, 16, 24))
    x[..., 1] = r.uniform(-0.6, 0.6, (4, 16))
    u = r.uniform(-10.0, 10.0, (4, 16, 24))
    dt = r.uniform(0.005, 0.02, 16)
    c = (r.uniform(size=(16, 4)) > 0.5).astype(float)
    cn = (r.uniform(size=(16, 4)) > 0.5).astype(float)

    def run(device, dt_, fn_dyn, fn_reset):
        a = [torch.as_tensor(v, device=device, dtype=dt_)
             for v in (x, u, dt, c, cn)]
        return (*fn_dyn(*a[:4]), fn_reset(a[0], a[3], a[4]))
    got = run(cuda, dtype, hkd.dynamics_partials_ad, hkd.reset_map_partial_ad)
    want = run("cpu", torch.float64, hkd.dynamics_partials_ad,
               hkd.reset_map_partial_ad)
    closed = run(cuda, dtype, hkd.dynamics_partials, hkd.reset_map_partial)
    for g, w, cf in zip(got, want, closed):
        assert g.device.type == "cuda" and g.dtype == dtype
        assert g.shape == (4, 16, 24, 24)
        assert _rel_err(g.cpu().double(), w) < tol
        assert _rel_err(g, cf) < tol


@pytest.mark.gpu
def test_hkd_runtime_runs_on_the_card_by_default(cuda):
    """`HKDMPCRuntime` without a device solves on the card."""
    from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
    qr = QuadReference(synthetic_bound_reference(duration=1.0))
    qr.initialize(0.3)
    rt = HKDMPCRuntime(qr, hp.HKDConfig(plan_duration=0.3, n_steps_max=40),
                       SolverOptions(max_AL_iter=1, max_DDP_iter=1))
    seen = []
    solve = rt.solve_init
    rt.solve_init = lambda plan, pen, *b: seen.append(
        [t.device.type for t in (plan.step.dt, pen.reb_delta, *b)]) \
        or solve(plan, pen, *b)
    before = sw.sweep.launches
    tape = rt.initialize(_standing(qr))
    assert seen == [["cuda"] * 5]
    assert sw.sweep.launches > before
    assert bool(rt.result.success) and np.isfinite(tape.controls).all()


def _standing(qr):
    body = np.zeros(12)
    body[5] = 0.2486
    t = torch.float64
    qd = hkd.compute_hkd_state(
        torch.tensor(body[0:3], dtype=t), torch.tensor(body[3:6], dtype=t),
        torch.tensor([0.0, -0.8, 1.6] * 4, dtype=t),
        torch.as_tensor(np.asarray(qr.contact_at_t(0.0), float), dtype=t))
    return np.concatenate([body, qd.numpy()])


@pytest.mark.gpu
def test_wbm_model_lives_on_the_card(cuda, robot):
    """Every tensor leaf of a model loaded for the card is on the card, at
    the asked dtype where it is floating."""
    m = wbm.load_model(robot, device="cuda", dtype=torch.float32)
    leaves = [f for f in m if torch.is_tensor(f)]
    assert leaves and all(t.device.type == "cuda" for t in leaves)
    assert all(t.dtype == torch.float32 for t in leaves
               if t.is_floating_point())


@pytest.mark.gpu
def test_model_layer_never_moves_to_the_cpu(cuda, robot, monkeypatch):
    """The entry points called with CUDA tensors never take a tensor to
    the host: Tensor.cpu and Tensor.numpy raise while they run."""
    wd, sd = _wb_knots(4), _srb_knots(4)

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor went to the host")

    m = wbm.load_model(robot, device="cuda", dtype=torch.float64)
    d = _on(wd, cuda, torch.float64)
    s = _on(sd, cuda, torch.float64)
    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    wb_lane.wb_dyn_partials_lane(m, d["x"], d["u"], d["dt"], d["c"], 10.0)
    wb_lane.wb_dynamics_lane(m, d["x"], d["u"], d["dt"], d["c"], 10.0)
    wb_lane.impulse_dynamics_partials_lane(m, d["x"][:, :18], d["x"][:, 18:],
                                           d["c"])
    wbm.dynamics_partials_analytic(m, d["x"], d["u"], 0.01, d["c"])
    wbm.impact_partial_analytic(m, d["x"], d["c"], 1.0 - d["c"])
    srb.dynamics_partials(s["x"], s["u"], s["pf"], s["c"], 0.02)
    torch.cuda.synchronize()


# ---- the MHPC cascade (segmented problem functions) --------------------

MHPC_PLAN = dict(plan_dur_wb=0.1, plan_dur_srb=0.2, n_steps_max=24,
                 wb_block=16)


def _mhpc_inputs(Bsz, seed=5):
    """The small cascaded plan (10 WB + 4 SRB knots) on the urdf-order
    synthetic bound reference, with Bsz perturbed initial states and
    perturbed states, controls and outputs for the problem functions."""
    qr = QuadReference(synthetic_bound_reference_urdf(duration=1.0))
    qr.initialize(0.4)
    cfg = mp.MHPCConfig(**MHPC_PLAN)
    plan_np, pen_np, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, cfg)
    rng = np.random.default_rng(seed)
    x0 = wb_state_ref_at(qr, 0.0)[None] + rng.normal(0, 0.01, (Bsz, 36))
    knots = dict(X=Xbar0[None] + rng.normal(0, 0.02, (Bsz,) + Xbar0.shape),
                 U=rng.normal(0, 2.0, (Bsz,) + Ubar0.shape),
                 Y=rng.normal(0, 20.0, (Bsz,) + Ubar0.shape))
    return cfg, (plan_np, pen_np, x0, Xbar0, Ubar0), knots


def _mhpc_fns(cfg, robot, device):
    return mp.make_mhpc_fns_segmented(
        cfg, wbm.load_model(robot, device, torch.float64))


# (function, per-knot): every problem function of both segments
MHPC_FNS = [("dyn", False), ("dyn_partials", False), ("run_cost", False),
            ("run_cost_partials", False), ("path_con", False),
            ("path_con_partials", False), ("term_cost", True),
            ("term_cost_partials", True), ("term_con", True),
            ("term_con_partials", True), ("reset", False),
            ("reset_partial", False)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,knot", MHPC_FNS)
def test_mhpc_fns_on_card_match_cpu(cuda, robot, name, knot):
    """Each problem function of the cascade's two segments (through the
    solver's fan-out; the resets at the gathered reset sites) on 2
    scenarios of the small plan, on the card in f64 against the CPU."""
    cfg, (plan_np, *_), kn = _mhpc_inputs(2)

    def run(device):
        fns = _mhpc_fns(cfg, robot, device)
        plan = from_numpy(plan_np, device, torch.float64)
        X, U, Y = (torch.as_tensor(kn[k], device=device) for k in "XUY")
        if name.startswith("reset"):
            st = hsddp.reset_sites(plan, 16, fns)[0]
            return getattr(st.fns, name)(X[:, st.idx], st.sd)
        f = hsddp._fan_out(fns, name, plan.n_steps, 1 if knot else 0)
        if knot:
            return f(X, plan.knot)
        if name.startswith("dyn"):
            return f(X[:, :-1], U, plan.step)
        return f(X[:, :-1], U, Y, plan.step)

    got, want = run(cuda), run("cpu")
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.float64
        assert _rel_err(g.cpu(), w) < 1e-10, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", MODEL_DTYPES)
def test_cf_partials_on_card_match_cpu(cuda, robot, dtype, tol):
    """The closed-form-bundle partials (the WB linearization and the
    impulse partials) of 16 knots on the card against the same knots in
    f64 on the CPU."""
    def run(device, dt):
        m = wb_lane.load_lane_model(robot, device, dt)
        d = _on(_wb_knots(16), device, dt)
        return (*wb_lane.wb_dyn_partials_lane(m, d["x"], d["u"], d["dt"],
                                              d["c"], 10.0),
                *wb_lane.impulse_dynamics_partials_lane(
                    m, d["x"][:, :18], d["x"][:, 18:], d["c"]))

    for g, w in zip(run(cuda, dtype), run("cpu", torch.float64)):
        assert g.device.type == "cuda" and g.dtype == dtype
        assert bool(torch.isfinite(g).all())
        assert _rel_err(g.cpu().double(), w) < tol


@pytest.mark.gpu
def test_joint_solve_through_kernels_matches_twins(cuda, robot):
    """A B=8 f64 solve of the small cascaded plan with the joint-mode
    functions (`make_mhpc_fns(cfg, model)`): through the sweep and linroll
    kernels against their twins, same success flags and iteration counts,
    trajectories to 1e-8."""
    cfg, host, _ = _mhpc_inputs(8)
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(host, cuda, torch.float64)
    args = (plan, broadcast_batch(pen, 8), x0, broadcast_batch(Xbar0, 8),
            broadcast_batch(Ubar0, 8))
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
    kw = dict(fused_riccati=True, parallel_line_search=False,
              max_resets=16, reg_floor=1e-3)
    fns = mp.make_mhpc_fns(cfg, wbm.load_model(robot, cuda, torch.float64))
    before = (sw.sweep.launches, lr.linroll.launches)
    got = make_solver(fns, opts, **kw)(*args)
    torch.cuda.synchronize()
    after = (sw.sweep.launches, lr.linroll.launches)
    assert after[0] > before[0] and after[1] > before[1]
    want = make_solver(fns, opts, plain_ops=True, **kw)(*args)
    assert (sw.sweep.launches, lr.linroll.launches) == after
    _same_solve(got, want)


@pytest.mark.gpu
def test_mhpc_solve_through_kernels_matches_twins(cuda, robot):
    """A B=4 f64 solve of the small cascaded plan: through the sweep and
    linroll kernels against their twins, same success flags and iteration
    counts, trajectories to 1e-8; the twin solve launches no kernel."""
    cfg, host, _ = _mhpc_inputs(4)
    plan_np, pen_np, x0, Xbar0, Ubar0 = host
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), cuda, torch.float64)
    args = (plan, broadcast_batch(pen, 4), x0, broadcast_batch(Xbar0, 4),
            broadcast_batch(Ubar0, 4))
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
    kw = dict(fused_riccati=True, parallel_line_search=False,
              max_resets=16, reg_floor=1e-3)
    fns = _mhpc_fns(cfg, robot, cuda)
    before = (sw.sweep.launches, lr.linroll.launches)
    got = make_solver(fns, opts, **kw)(*args)
    torch.cuda.synchronize()
    after = (sw.sweep.launches, lr.linroll.launches)
    assert after[0] > before[0] and after[1] > before[1]
    want = make_solver(fns, opts, plain_ops=True, **kw)(*args)
    assert (sw.sweep.launches, lr.linroll.launches) == after
    _same_solve(got, want)


@pytest.mark.gpu
def test_barrel_roll_solve_through_kernels_matches_twins(cuda, robot,
                                                         tmp_path):
    """The 131-knot barrel roll at B=1 in f64, 1 AL x 2 DDP, on the
    synthetic settings: through the sweep and linroll kernels against
    their twins, same success and iteration counts, trajectories to 1e-8;
    the twin solve launches no kernel."""
    from cafempc_tpu_torch.problems import barrel_roll as br
    from cafempc_tpu_torch.reference.synthetic import \
        write_synthetic_br_settings
    plan_np, pen_np, Xbar0, Ubar0, _ = br.build_barrel_roll_plan(
        write_synthetic_br_settings(str(tmp_path)))
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, br.initial_state(), Xbar0, Ubar0), cuda,
        torch.float64)
    args = (plan, broadcast_batch(pen, 1), x0[None], Xbar0[None],
            Ubar0[None])
    fns = br.make_barrel_roll_fns(wbm.load_model(robot, cuda, torch.float64))
    opts = SolverOptions(max_AL_iter=1, max_DDP_iter=2)
    before = (sw.sweep.launches, lr.linroll.launches)
    kw = dict(fused_riccati=True, parallel_line_search=False, max_resets=16)
    got = make_solver(fns, opts, **kw)(*args)
    torch.cuda.synchronize()
    after = (sw.sweep.launches, lr.linroll.launches)
    assert after[0] > before[0] and after[1] > before[1]
    want = make_solver(fns, opts, plain_ops=True, **kw)(*args)
    assert (sw.sweep.launches, lr.linroll.launches) == after
    _same_solve(got, want)


class _Loopback:
    """An in-memory transport: what one endpoint publishes, it handles."""

    def __init__(self):
        self.queue, self.handlers = [], {}

    def publish(self, channel, data):
        self.queue.append((channel, bytes(data)))

    def subscribe(self, channel, handler):
        self.handlers.setdefault(channel, []).append(handler)

    def handle(self, timeout=0.1):
        if not self.queue:
            return False
        channel, data = self.queue.pop(0)
        for h in self.handlers.get(channel, []):
            h(channel, data)
        return True

    def close(self):
        pass


@pytest.mark.gpu
def test_served_hkd_solves_launch_the_kernels(cuda):
    """A small HKD runtime on the card served two states over an
    in-memory transport: each solve launches the sweep and the linroll
    kernels, and each state gets its command."""
    from cafempc_tpu_torch.comms import lcm_wire as w
    from cafempc_tpu_torch.comms.udpm import LCMEndpoint
    from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
    qr = QuadReference(synthetic_bound_reference(duration=1.0))
    qr.initialize(0.3)
    rt = HKDMPCRuntime(qr, hp.HKDConfig(plan_duration=0.3, n_steps_max=40),
                       SolverOptions(), device=cuda, dtype=torch.float64)
    ep = LCMEndpoint(_Loopback())
    cmds = []
    ep.subscribe("mpc_command", w.hkd_command_lcmt,
                 lambda _c, m: cmds.append(m))
    for i, t in enumerate((0.0, 0.02)):
        ep.publish("mpc_data", w.hkd_data_lcmt(
            reset_mpc=i == 0, MS=True, mpctime=t,
            contact=np.ones(4, np.int32), p=[0.0, 0.0, 0.2486],
            vWorld=np.zeros(3), rpy=np.zeros(3), omegaBody=np.zeros(3),
            qJ=[0.0, -0.8, 1.6] * 4, foot_placements=np.zeros(12)))
        before = (sw.sweep.launches, lr.linroll.launches)
        assert rt.serve(ep, max_msgs=1) == 1
        assert sw.sweep.launches > before[0]
        assert lr.linroll.launches > before[1]
        assert bool(rt.result.success)
    while ep.handle():
        pass
    assert [c.mpc_times[0] for c in cmds] == [0.0, 0.02]
    assert all(np.isfinite(c.hkd_controls).all() for c in cmds)


# ---- the scale-out layer and the scenario sweep -------------------------

@pytest.mark.gpu
def test_knot_sweep_on_card_matches_exact_sweep(cuda):
    """The knot-sharded sweep stage over 4 blocks on the card (f64, B=3,
    N=23: the identity padding, transform steps inside and between
    blocks) against the exact sequential sweep on the same operands:
    equal ok flags, G, H and K of the ok scenarios to 1e-7 normalized; no
    kernel launch."""
    d = make_inputs(np.random.default_rng(17), 3, 23, 6, 3, w_idx=(5, 8, 16),
                    luu_shift=0.5, fail=(2,))
    w = d["w"] > 0
    f64 = dict(device=cuda, dtype=torch.float64)
    dyn = torch.as_tensor(~w, device=cuda)[None, :, None]
    t = {k: torch.as_tensor(d[k], **f64) for k in (
        "A", "Bm", "lx", "lu", "lxx", "luu", "lux", "defect")}
    phix = torch.zeros(3, 24, 6, **f64)
    phixx = torch.zeros(3, 24, 6, 6, **f64)
    phix[:, :-1] = torch.where(dyn, 0.0, t["lx"])
    phixx[:, :-1] = torch.where(dyn[..., None], 0.0, t["lxx"])
    phix[:, -1] = torch.as_tensor(d["phix_T"], **f64)
    phixx[:, -1] = torch.as_tensor(d["phixx_T"], **f64)
    tr = hsddp.init_traj(type("P", (), {"n_steps": 23})(), 6, 3, 0,
                         torch.zeros(3, 24, 6, **f64),
                         torch.zeros(3, 23, 3, **f64))
    tr = tr._replace(A=t["A"], B=t["Bm"] * dyn[..., None],
                     lx=t["lx"] * dyn, lu=t["lu"] * dyn,
                     lxx=t["lxx"] * dyn[..., None],
                     luu=t["luu"] * dyn[..., None],
                     lux=t["lux"] * dyn[..., None], phix=phix, phixx=phixx,
                     Defect=t["defect"])
    plan = type("P", (), {"step": type("S", (), dict(
        is_reset=torch.as_tensor(w, **f64),
        active=torch.ones(23, **f64)))()})()
    reg = torch.as_tensor(d["reg"], **f64)
    solve = make_solver(hp.make_hkd_fns(), SolverOptions(), knot_axis="knot",
                        knot_shards=4, knot_devices=[cuda] * 4)
    before = sw.sweep.launches
    got = solve._backward_sweep_knot(plan, tr, reg)
    want = solve._backward_sweep(plan, tr, reg)
    assert sw.sweep.launches == before
    assert torch.equal(got[3], want[3]) and got[3].tolist() == [True, True,
                                                                 False]
    ok = got[3]
    for i in (0, 1, 2):                                   # G, H, K
        assert got[0][i].device.type == cuda.type
        assert _rel_err(got[0][i][ok], want[0][i][ok]) < 1e-7


@pytest.mark.gpu
def test_mhpc_chain_through_kernels_matches_twins(cuda, robot):
    """The scenario sweep's MPC chain (small cascaded plan from 0.04 s,
    2 plans, B=8, f64, 2 AL x 1 DDP): through the sweep and linroll
    kernels against the same chain through their twins, on the same
    scenarios: same success flags and iteration counts at both steps,
    trajectories to 1e-8; the twin chain launches no kernel."""
    from cafempc_tpu_torch.tools import scenario_sweep as ss
    cfg = mp.MHPCConfig(**MHPC_PLAN)
    model = wbm.load_model(robot, cuda, torch.float64)
    fns = mp.make_mhpc_fns_segmented(cfg, model)
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
    runs = {}
    for plain in (False, True):
        qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
        qr.initialize(0.4)
        qr.step(cfg.dt_mpc)
        qr.step(cfg.dt_mpc)
        steps, props = ss.mhpc_chain(qr, cfg, model, cuda, torch.float64, 2)
        solve = make_solver(fns, opts, plain_ops=plain, **ss.MHPC_KW)
        log = []
        before = (sw.sweep.launches, lr.linroll.launches)
        r = ss.run_case_chain(lambda *a: log.append(solve(*a)) or log[-1],
                              None, steps, 8, 8, np.random.default_rng(0),
                              torch.float64, props, seen_bs={8})
        torch.cuda.synchronize()
        launched = (sw.sweep.launches - before[0],
                    lr.linroll.launches - before[1])
        assert (launched == (0, 0)) if plain else min(launched) > 0
        assert r["n_solves"] == 16 and len(log) == 2
        runs[plain] = log
    for got, want in zip(runs[False], runs[True]):
        assert bool(torch.isfinite(got.cost).all())
        _same_solve(got, want)

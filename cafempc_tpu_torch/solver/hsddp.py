"""Hybrid-Systems DDP solver, batched over scenarios (port of
`cafempc_tpu/solver/hsddp.py`).

The JAX package builds one per-scenario solve and vmaps it; here every
function takes the whole batch: per-scenario tensors carry a leading
dimension B, plan tensors (shared by all scenarios) carry none.
`make_solver` takes the JAX signature's keywords with its defaults, for a
`ProblemFns` or a `SegmentedFns`, and picks the same stages:

  * rollout: all-shooting multiple shooting (every knot a shooting state,
    `all_shooting=True` and `opts.MS`), the one-step simulations of all
    knots at once; otherwise the sequential single/partial-shooting
    rollout.  The reset map is evaluated at every step under a select
    (`max_resets=None`), or only at each segment's gathered reset steps
    (`max_resets=R`, which raises on a segment with more);
  * for `SegmentedFns` (a cascaded plan), every problem function runs on
    its own segment's steps and knots only, the outputs concatenated;
  * LQ approximation from the problem's closed-form partials (in chunks of
    `lq_knot_chunk` knots, if set), or a problem's fused LQ hook
    (`fused_lq`);
  * Riccati backward sweep, inside the regularization retry loop: the
    sequential sweep with an exact Cholesky (default), the
    associative-scan sweep (`parallel_riccati`), the same scan cut into
    knot blocks over devices (`knot_axis`), or `ops.sweep`, the hand CUDA
    kernel on CUDA tensors (`fused_riccati`);
  * linear rollout: an associative prefix composition (default), the
    sequential recursion, or `ops.linroll` (`fused_linroll`, which
    defaults to `fused_riccati`);
  * merit line search over all backtracking candidates in one batched
    rollout (default) or sequential backtracking; a problem's fused trial
    hook (`fused_forward`) replaces the rollout and cost stages of the
    sequential search and of the initial rollout;
  * DDP inner and AL outer loops.

Loop semantics follow the vmapped JAX program exactly, but for one
departure on purpose: the sequential line search counts its trials in
double (`_n_steps`), as the C++ reference's loop steps its eps, so that a
float32 solve tries the same step sizes as a float64 one; the JAX
package's float32 search tests its float32 eps and ends one trial early
(0.1**3 rounds to float32(1e-3)).  Each `while` runs
while ANY scenario's condition holds, and a scenario whose condition is
false keeps its carry unchanged (`tree_where`), iteration counters
included.  One host sync per loop test (`_n_set`), which fetches how many
scenarios' conditions hold: the select that follows it copies nothing
where all or none do.

Spans and counters (`utils/tracing.py`, off by default): `hsddp.solve`
around a call, and inside it `hsddp.rollout` (the initial forward),
`hsddp.outer`, `hsddp.inner`, `hsddp.lq`, `hsddp.sweep` (with its
regularization retries), `hsddp.linroll`, `hsddp.line_search`,
`hsddp.select` (each `tree_where`), `hsddp.al_update` and `hsddp.sync`
(each host sync: every loop test, and each segment's reset-site fetch),
which the `hsddp.sync` counter counts; the stages that launch device work
carry CUDA events on the card.  The counters `hsddp.select_skip` and
`hsddp.select_copy` count the leaves `tree_where` passed through and
those it selected on the device.
"""
from typing import Any, Callable, NamedTuple

import torch

from cafempc_tpu_torch.ops import linroll as linroll_mod
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.solver import penalty
from cafempc_tpu_torch.solver.options import SolverOptions
from cafempc_tpu_torch.solver.plan import KnotPlan, PenaltyParams, StepData
from cafempc_tpu_torch.solver.scan import associative_scan
from cafempc_tpu_torch.utils import tracing


class ProblemFns(NamedTuple):
    """Problem-specific batched functions consumed by the solver.

    Per-step functions take X [B, n, xs], U [B, n, us], Y [B, n, ys] and a
    StepData slice with leading dim n; per-knot functions take X and a
    KnotData slice.  Shapes mirror the JAX ProblemFns with [B, n] leading.
    """
    dyn: Callable                 # (X, U, sd) -> (Xnext, Y)
    dyn_partials: Callable        # (X, U, sd) -> (A, B, C, D)
    reset: Callable               # (X, sd) -> Xnext
    reset_partial: Callable       # (X, sd) -> Px
    run_cost: Callable            # (X, U, Y, sd) -> l [B, n] (dt-scaled)
    run_cost_partials: Callable   # -> (lx, lu, ly, lxx, luu, lux, lyy)
    term_cost: Callable           # (X, kd) -> phi [B, n]
    term_cost_partials: Callable  # (X, kd) -> (phix, phixx)
    path_con: Callable            # (X, U, Y, sd) -> g [B, n, n_pcon]
    path_con_partials: Callable   # (X, U, Y, sd) -> (gx, gu, gy)
    term_con: Callable            # (X, kd) -> h [B, n, n_tcon]
    term_con_partials: Callable   # (X, kd) -> hx [B, n, n_tcon, xs]


class SegmentedFns(NamedTuple):
    """Static per-segment problem functions for cascaded plans.

    Segment i owns steps [sum(counts[:i]), sum(counts[:i+1])) of the flat
    plan and the matching knots; the last segment also owns the final
    knot.  The solver runs each segment's functions on its own slice only,
    so one model's dynamics and partials are never evaluated on the
    other's knots (the reference's per-phase LQ touches only its own model,
    SinglePhase.cpp:265-320).  Requires a plan that puts each model's steps
    at static offsets (mhpc_problem.build_mhpc_plan's carry-pad layout).
    """
    counts: tuple   # ints, sum == n_steps
    fns: tuple      # ProblemFns per segment


class TrajState(NamedTuple):
    """Working trajectory data (reference TrajectoryManagement.h:22-85)."""
    Xbar: Any; Ubar: Any; Defect_bar: Any
    X: Any; U: Any; Y: Any; Xsim: Any; Defect: Any
    dX: Any; dU: Any; K: Any
    A: Any; B: Any; C: Any; D: Any
    lx: Any; lu: Any; ly: Any; lxx: Any; luu: Any; lux: Any; lyy: Any
    phix: Any; phixx: Any
    G: Any; H: Any
    Qu: Any; Quu: Any; Qux: Any


class SolverInfo(NamedTuple):
    """Iteration telemetry (MultiPhaseDDP.h:133-136), per scenario."""
    cost_buf: Any
    dyn_feas_buf: Any
    eqn_feas_buf: Any
    ineq_feas_buf: Any
    n_entries: Any
    iters: Any
    ls_iters: Any
    reg_iters: Any


class SolverState(NamedTuple):
    traj: TrajState
    pen: PenaltyParams
    x0: Any
    cost: Any; merit: Any; merit_rho: Any; feas: Any
    dV1: Any; dV2: Any
    reg: Any
    max_pconstr: Any; max_tconstr: Any
    max_pconstr_prev: Any; max_tconstr_prev: Any
    # penalty-independent cost terms of the accepted nominal, re-folded
    # under each AL update without re-evaluating the trajectory
    cost_quad: Any; con_g: Any; con_h: Any
    success: Any          # False only on unrecoverable backward-sweep failure
    done: Any             # outer-loop termination flag
    info: SolverInfo


# the SolverState fields that an AL outer iteration rewrites for every
# scenario, those outside its mask too
OUTER_REWRITES = ("max_pconstr_prev", "max_tconstr_prev", "reg", "pen",
                  "done")


class SolveResult(NamedTuple):
    """Trimmed solver output: what the MPC command tape consumes plus
    telemetry."""
    Xbar: Any; Ubar: Any; K: Any
    Qu: Any; Quu: Any; Qux: Any
    cost: Any; feas: Any
    max_pconstr: Any; max_tconstr: Any
    success: Any
    info: SolverInfo


def tree_where(mask, new, old, n_set=None):
    """Per-scenario select over matching trees (NamedTuples / tuples) of
    [B, ...] tensors: scenario b takes `new` where mask[b], else `old`
    (one `hsddp.select` span).

    Only what can differ is copied, and the result equals the per-leaf
    `torch.where` bit for bit.  A leaf that is the same tensor on both
    sides (the same object, or the same storage, shape and strides) comes
    back as it is.  `n_set`, the count of set flags that the caller's loop
    test fetched (`_n_set`): with all set every leaf is `new`'s, with none
    set `old`'s.  Either way nothing is launched, except for a leaf whose
    sides differ in dtype or shape, which `torch.where` promotes or
    broadcasts.  Counts `hsddp.select_skip` per leaf passed through and
    `hsddp.select_copy` per leaf selected on the device."""
    take_new = (None if n_set is None or 0 < n_set < mask.numel()
                else n_set > 0)
    n = [0, 0]      # leaves skipped, copied
    with tracing.span("hsddp.select", device=mask):
        out = _select(mask, new, old, take_new, n)
    tracing.count("hsddp.select_skip", n[0])
    tracing.count("hsddp.select_copy", n[1])
    return out


def _same(a, b):
    return a is b or (a.data_ptr() == b.data_ptr() and a.device == b.device
                      and a.dtype == b.dtype and a.shape == b.shape
                      and a.stride() == b.stride())


def _select(mask, new, old, take_new, n):
    if isinstance(new, torch.Tensor):
        # what torch.where would return is one side unchanged only where
        # neither promotion nor broadcasting enters
        if new.dtype == old.dtype and new.shape == old.shape \
                and new.shape[:1] == mask.shape:
            if _same(new, old):
                n[0] += 1
                return new
            if take_new is not None:
                n[0] += 1
                return new if take_new else old
        n[1] += 1
        return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)),
                           new, old)
    vals = [_select(mask, a, b, take_new, n) for a, b in zip(new, old)]
    return type(new)(*vals) if hasattr(new, "_fields") else tuple(vals)


def _n_set(mask):
    """How many scenarios' flags are set: a host sync, one reduction and
    one fetch.  A loop test reads it as whether any is set; `tree_where`
    as whether all or none are."""
    tracing.count("hsddp.sync")
    with tracing.span("hsddp.sync"):
        return int(mask.sum())


def init_traj(plan: KnotPlan, xs, us, ys, Xbar0, Ubar0):
    B, N = Ubar0.shape[0], plan.n_steps

    def z(*shape):
        return Xbar0.new_zeros((B,) + shape)

    return TrajState(
        Xbar=Xbar0, Ubar=Ubar0, Defect_bar=z(N + 1, xs),
        X=Xbar0, U=Ubar0, Y=z(N, ys), Xsim=Xbar0, Defect=z(N + 1, xs),
        dX=z(N + 1, xs), dU=z(N, us), K=z(N, us, xs),
        A=z(N, xs, xs), B=z(N, xs, us), C=z(N, ys, xs), D=z(N, ys, us),
        lx=z(N, xs), lu=z(N, us), ly=z(N, ys),
        lxx=z(N, xs, xs), luu=z(N, us, us), lux=z(N, us, xs),
        lyy=z(N, ys, ys),
        phix=z(N + 1, xs), phixx=z(N + 1, xs, xs),
        G=z(N + 1, xs), H=z(N + 1, xs, xs),
        Qu=z(N, us), Quu=z(N, us, us), Qux=z(N, us, xs))


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _t(M):
    return M.transpose(-1, -2)


def _cholesky_ok(M):
    """Cholesky factor of M [..., n, n] and whether it exists, as JAX's
    `all(isfinite(cholesky(M)))` reads it (LAPACK's factorization reports
    a failed pivot by `info`, where JAX's factor is NaN)."""
    L, info = torch.linalg.cholesky_ex(M)
    return L, (info == 0) & torch.isfinite(L).all(dim=(-1, -2))


def riccati_lft_elements(A, B, C, D, lx, lu, ly, lxx, luu, lux, lyy,
                         phix, phixx, defect, w, reg):
    """Per-knot linear-fractional-transform elements of the Riccati
    backward map (cf. PAPERS.md: Parallelization of Riccati Recursion):
    5-tuple (A, b, C, eta, J) per knot, [B, N+1, ...] with the terminal
    cost as the last element.  Dynamics steps eliminate u around the
    regularized luu; reset/padding steps (w [N] bool) are plain affine
    transforms (G <- Px^T G, H <- Px^T H Px).  Operands batch-leading as in
    TrajState; reg [B].  Also returns the output-equation-folded
    (lx, lu, lxx, luu, lux)."""
    xs = A.shape[-1]
    us = B.shape[-1]
    I_u = torch.eye(us, dtype=A.dtype, device=A.device)
    I_x = torch.eye(xs, dtype=A.dtype, device=A.device)
    r = reg[:, None, None, None]

    lyC = torch.einsum("bkij,bki->bkj", C, ly)
    lyD = torch.einsum("bkij,bki->bkj", D, ly)
    lxx = lxx + torch.einsum("bkji,bkjl,bklm->bkim", C, lyy, C) + r * I_x
    luu = luu + torch.einsum("bkji,bkjl,bklm->bkim", D, lyy, D) + r * I_u
    lux = lux + torch.einsum("bkji,bkjl,bklm->bkim", D, lyy, C)
    lx = lx + lyC
    lu = lu + lyD

    # transform steps may carry a singular luu (0 at reg 0): their
    # dynamics-branch values are discarded below, as under JAX's select
    luu_inv = torch.linalg.inv_ex(luu)[0]
    Kc = luu_inv @ lux
    kc = _mv(luu_inv, lu)
    A_d = A - B @ Kc
    b_d = defect[:, 1:] - _mv(B, kc)
    C_d = torch.einsum("bkij,bkjl,bkml->bkim", B, luu_inv, B)
    eta_d = lx - torch.einsum("bkji,bkj->bki", Kc, lu)
    J_d = lxx - torch.einsum("bkji,bkjl->bkil", lux, Kc)
    J_d = 0.5 * (J_d + _t(J_d))

    wA = w[:, None, None]
    wv = w[:, None]
    A_e = torch.where(wA, A, A_d)
    b_e = torch.where(wv, defect[:, 1:], b_d)
    C_e = torch.where(wA, torch.zeros_like(C_d), C_d)
    eta_e = torch.where(wv, phix[:, :-1], eta_d)
    J_e = torch.where(wA, phixx[:, :-1], J_d)

    zx = A.new_zeros(A.shape[0], 1, xs)
    zxx = A.new_zeros(A.shape[0], 1, xs, xs)
    A_e = torch.cat([A_e, zxx], 1)
    b_e = torch.cat([b_e, zx], 1)
    C_e = torch.cat([C_e, zxx], 1)
    eta_e = torch.cat([eta_e, phix[:, -1:]], 1)
    J_e = torch.cat([J_e, phixx[:, -1:]], 1)
    return (A_e, b_e, C_e, eta_e, J_e), (lx, lu, lxx, luu, lux)


def lft_combine(later, earlier):
    """Associative composition of Riccati LFT elements (tensors with any
    leading dims); folds as fn(suffix, elem) under
    associative_scan(reverse=True) — first arg the later-time composite,
    second the earlier element."""
    Af, bf, Cf, etaf, Jf = earlier
    Al, bl, Cl, etal, Jl = later
    xs = Af.shape[-1]
    I_x = torch.eye(xs, dtype=Af.dtype, device=Af.device)
    M = torch.linalg.solve_ex(
        I_x + Cf @ Jl,
        torch.cat([Af, (bf - _mv(Cf, etal))[..., None], Cf], -1))[0]
    MA = M[..., :xs]
    Mb = M[..., xs]
    MC = M[..., xs + 1:]
    Nt = torch.linalg.solve_ex(
        I_x + Jl @ Cf,
        torch.cat([Jl @ Af, (etal + _mv(Jl, bf))[..., None]], -1))[0]
    NJ = Nt[..., :xs]
    Ne = Nt[..., xs]
    A_t = Al @ MA
    b_t = _mv(Al, Mb) + bl
    C_t = (Al @ MC) @ _t(Al) + Cl
    eta_t = _mv(_t(Af), Ne) + etaf
    J_t = _t(Af) @ NJ + Jf
    J_t = 0.5 * (J_t + _t(J_t))
    return (A_t, b_t, C_t, eta_t, J_t)


class _ResetSites(NamedTuple):
    """Gathered reset steps of one segment of a plan (shared by the whole
    batch)."""
    fns: ProblemFns         # the segment's problem functions
    idx: torch.Tensor       # [R] plan step indices, padded with the
    #                         segment's first step
    valid: torch.Tensor     # [R] bool, False on padding entries
    sd: StepData            # the StepData rows at idx


def _segments(fns, n_steps):
    """[(offset, count, ProblemFns)] of the plan's segments: one for a
    ProblemFns, one per segment of a SegmentedFns."""
    if not isinstance(fns, SegmentedFns):
        return [(0, n_steps, fns)]
    counts = [int(c) for c in fns.counts]
    if sum(counts) != n_steps or len(counts) != len(fns.fns) \
            or min(counts) < 1:
        raise ValueError(f"SegmentedFns: counts {counts} must be positive, "
                         f"one per segment, and sum to the plan's "
                         f"{n_steps} steps")
    offsets = [sum(counts[:i]) for i in range(len(counts))]
    return list(zip(offsets, counts, fns.fns))


def reset_sites(plan: KnotPlan, max_resets, fns):
    """Per segment of `fns`, its reset steps padded to `max_resets` entries,
    as `jnp.nonzero(is_reset[o:o+n] > 0, size=max_resets, fill_value=0)`
    picks them (hsddp.py:446-457): padded with the segment's first step,
    masked by `valid`.  Raises ValueError on a segment with more reset
    steps than `max_resets`, where the JAX gathered mode drops the rest."""
    sites = []
    for i, (o, cnt, f) in enumerate(_segments(fns, plan.n_steps)):
        is_r = plan.step.is_reset[o:o + cnt]
        tracing.count("hsddp.sync")
        with tracing.span("hsddp.sync"):
            idx = torch.nonzero(is_r > 0).flatten()
        if idx.shape[0] > max_resets:
            raise ValueError(
                f"segment {i} of the plan (steps {o}..{o + cnt - 1}) has "
                f"{idx.shape[0]} reset steps, more than max_resets="
                f"{max_resets}: raise the cap, or pass max_resets=None to "
                f"evaluate the reset map at every step")
        idx = torch.cat([idx, idx.new_zeros(max_resets - idx.shape[0])])
        sites.append(_ResetSites(f, idx + o, is_r[idx] > 0,
                                 StepData(*[a[o + idx] for a in plan.step])))
    return sites


def _chunked(fn, chunk):
    """`fn` over sequential pieces of `chunk` knots along dim 1 (per-knot
    tensors [B, n, ...]; the plan slice, the last argument, along dim 0),
    the outputs concatenated: the same values with the live temporaries of
    one piece (the JAX package's `lq_knot_chunk` lax.map of a chunk-wide
    vmap)."""
    def run(*args):
        *xs, pd = args
        n = pd[0].shape[0]
        if n <= chunk:
            return fn(*args)
        outs = [fn(*[a[:, i:i + chunk] for a in xs],
                   type(pd)(*[a[i:i + chunk] for a in pd]))
                for i in range(0, n, chunk)]
        if torch.is_tensor(outs[0]):
            return torch.cat(outs, 1)
        return tuple(torch.cat(parts, 1) for parts in zip(*outs))
    return run


def _fan_out(fns, attr, n_steps, n_extra=0, chunk=None):
    """The problem function `attr` over the whole plan: for a ProblemFns the
    function itself; for a SegmentedFns each segment's function on its own
    slice (per-scenario tensors [B, n, ...] along dim 1, the plan slice,
    the last argument, along dim 0), the outputs concatenated.  n_extra=1
    for per-knot functions: the last segment also owns the final knot.
    chunk: each segment's function runs in pieces of that many knots
    (`_chunked`)."""
    def seg_fn(f):
        g = getattr(f, attr)
        return _chunked(g, chunk) if chunk else g

    if not isinstance(fns, SegmentedFns):
        return seg_fn(fns)
    segs = _segments(fns, n_steps)

    def apply(*args):
        *xs, pd = args
        outs = []
        for i, (o, cnt, f) in enumerate(segs):
            c = cnt + (n_extra if i == len(segs) - 1 else 0)
            outs.append(seg_fn(f)(
                *[a[:, o:o + c] for a in xs],
                type(pd)(*[a[o:o + c] for a in pd])))
        if torch.is_tensor(outs[0]):
            return torch.cat(outs, 1)
        return tuple(torch.cat(parts, 1) for parts in zip(*outs))
    return apply


INFO_LEN = 64   # entries of the per-iteration telemetry buffers


def _quad(v, M, w):
    """sum_ij v_i M_ij w_j over trailing axes."""
    return torch.einsum("...i,...ij,...j->...", v, M, w)


def _per_lane(v):
    """A per-scenario scalar [B] or vector [B, n] broadcast against a
    [B, N, n] stack."""
    return v[:, None, None] if v.dim() == 1 else v[:, None, :]


def _n_steps(opts, slack):
    """The backtracking step sizes 1, alpha, alpha^2, ... above
    ls_eps_min * (1 + slack), counted in double whatever the solve's
    dtype.  The sequential search takes slack 0, the C++ reference's
    double loop (MultiPhaseDDP.cpp:95-133): 0.1**3 = 1.0000000000000002e-3
    > 1e-3, so four trials at the default options.  The parallel search
    keeps the JAX package's 1e-12 slack (hsddp.py:1005-1011), which
    counts three candidates there: its step set lacks the sequential
    search's last, smallest step."""
    n, e = 0, 1.0
    while e > opts.ls_eps_min * (1.0 + slack) and n < 64:
        n += 1
        e *= opts.alpha
    return n


def make_solver(fns, opts: SolverOptions, *, all_shooting=True,
                info_len=INFO_LEN, trim_output=True,
                parallel_linear_rollout=True, parallel_riccati=False,
                parallel_line_search=True, fused_riccati=False,
                fused_linroll=None, max_resets=None, iter_callback=None,
                reg_floor=0.0, fused_forward=None, fused_lq=None,
                lq_knot_chunk=None, knot_axis=None, knot_shards=1,
                knot_devices=None, plain_ops=False):
    """Build ``solve(plan, pen, x0, Xbar0, Ubar0)`` over a batch: a
    `SolveResult` (the JAX package's `trim_output=True` output), or with
    trim_output=False the final `SolverState` (whose traj carries, e.g.,
    the output trajectory Y that the MHPC command tape reads).

    The keywords are the JAX make_solver's, with its defaults (masked
    resets, the exact sequential sweep, the scan linear rollout, the
    batched line search), except trim_output; the port adds plain_ops.

    fns: a ProblemFns, or a SegmentedFns for cascaded plans with a static
    per-model step layout (each segment's functions see only its steps and
    knots, and reset sites are gathered per segment).

    plan: KnotPlan of unbatched tensors; pen: PenaltyParams with a leading
    scenario dim B; x0 [B, xs]; Xbar0 [B, N+1, xs]; Ubar0 [B, N, us].
    all_shooting: every active knot is a shooting state (with opts.MS, the
    knot-parallel rollout); otherwise the sequential rollout.
    parallel_linear_rollout / parallel_riccati / parallel_line_search:
    the associative-scan linear rollout (else the sequential recursion),
    the associative-scan Riccati sweep (else the sequential sweep), the
    batched-candidate line search (else sequential backtracking).
    fused_riccati / fused_linroll: the sweep and the linear rollout through
    the hand kernels `ops.sweep` / `ops.linroll` (the Pallas kernels' pivot
    rule); fused_linroll=None follows fused_riccati.
    max_resets: None evaluates the reset map and its partial at every step
    under a select; an int evaluates them only at each segment's reset
    steps, gathered, and raises ValueError on a segment with more.
    reg_floor: minimum regularization of every backward sweep attempt
    (0.0 = the reference schedule, MultiPhaseDDP.cpp:136-165).
    fused_forward: optional problem-specific fused trial
    ``f(plan, pen, tr, x0, eps, plain_ops) -> (tr2, (cq, g, h), cost,
    feas, maxp, maxt, ok)`` with eps [B], replacing rollout + cost_terms +
    cost_from_terms + dyn_feas in the line search and the initial rollout
    (e.g. problems/hkd_fused.make_hkd_fused_forward).  It applies the
    reset map at every reset step, as the generic rollout does (gathered
    or masked).  Requires the sequential line search and the all-shooting
    MS configuration.
    fused_lq: optional problem-specific fused LQ approximation
    ``f(plan, pen, tr, plain_ops) -> tr`` replacing lq_approx (e.g.
    problems/hkd_fused.make_hkd_fused_lq); it sets the fields lq_approx
    sets, or leaves them zero.  Excludes lq_knot_chunk.
    lq_knot_chunk: evaluate the per-knot dynamics, cost and path-constraint
    partials in sequential pieces of this many knots (per segment): the
    same outputs, live temporaries capped at a piece.
    knot_axis / knot_shards: the knot-sharded sweep
    (parallel/knot_riccati.py): the associative-scan sweep's suffix
    composition cut into knot_shards >= 2 contiguous blocks, each scanned
    on its device, then joined by each block's tail transform.  knot_axis
    names the mesh axis (make_batched_solver passes it); knot_devices, a
    port keyword, lists the blocks' devices (default: every block on the
    operands' device).  The JAX package lets knot_axis silently replace
    fused_riccati; here asking for both raises ValueError.
    plain_ops: run the plain PyTorch twins of every kernel (the sweep, the
    linear rollout, and those of the fused hooks) even on CUDA tensors —
    for comparing a solve against its kernel solve on the card; the
    default dispatches CUDA tensors to the kernels.
    iter_callback: optional host callback ``f(Xbar, Ubar, it)`` called after
    every AL outer iteration with the batch's nominal trajectory (tensors
    [B, N+1, xs] and [B, N, us] on the solve's device) and the iteration's
    0-based index: the JAX package's io_callback, the reference's
    intermediate-trajectory publishing (MultiPhaseDDP.h:95-107).  Without
    it the loop makes no host fetch for it.
    info_len: entries of the telemetry buffers (the initial rollout and
    one per DDP iteration; later entries overwrite the last).
    """
    if knot_axis is not None and knot_shards < 2:
        raise ValueError("knot_axis requires knot_shards >= 2 (the "
                         "static size of the mesh axis)")
    if knot_axis is not None and fused_riccati:
        raise ValueError("knot_axis and fused_riccati are mutually "
                         "exclusive: the knot-sharded sweep replaces the "
                         "sweep kernel")
    if knot_devices is not None and (knot_axis is None
                                     or len(knot_devices) != knot_shards):
        raise ValueError(f"knot_devices: one device per knot block "
                         f"(knot_shards={knot_shards}), with knot_axis")
    multiple_shooting = all_shooting and opts.MS
    if fused_forward is not None and (parallel_line_search
                                      or not multiple_shooting):
        raise ValueError("fused_forward requires the sequential line "
                         "search and the all-shooting MS configuration")
    if fused_lq is not None and lq_knot_chunk:
        raise ValueError("fused_lq and lq_knot_chunk are mutually "
                         "exclusive: the fused LQ kernel bypasses the "
                         "generic (chunkable) LQ path")
    if isinstance(fns, SegmentedFns):
        if not multiple_shooting:
            raise ValueError("SegmentedFns requires the all-shooting "
                             "multiple-shooting configuration")
        if fused_forward or fused_lq:
            raise ValueError("the fused hooks replace the problem functions "
                             "of the whole plan; SegmentedFns takes neither")
    if fused_linroll is None:
        fused_linroll = fused_riccati
    sweep_kernel = sweep_mod.sweep_reference if plain_ops else sweep_mod.sweep
    linroll_kernel = (linroll_mod.linroll_reference if plain_ops
                      else linroll_mod.linroll)
    n_ls = max(_n_steps(opts, 1e-12), 1)
    n_trials = _n_steps(opts, 0.0)

    # ---------------- rollout ----------------------------------------
    def step_sim(plan, sites, X, U, sd):
        """One-step simulations (Xnext, Y) of every step of `sd` from X:
        the dynamics, with the reset map at the reset steps (gathered
        sites, or a select at every step when sites is None)."""
        N = plan.n_steps
        Xn, Y = _fan_out(fns, "dyn", N)(X, U, sd)
        if sites is None:
            Xr = _fan_out(fns, "reset", N)(X, sd)
            return torch.where(sd.is_reset[:, None] > 0, Xr, Xn), Y
        for st in sites:
            xr = st.fns.reset(X[:, st.idx], st.sd)
            rows = torch.where(st.valid[:, None], xr, Xn[:, st.idx])
            Xn = Xn.index_copy(1, st.idx, rows)
        return Xn, Y

    def rollout(plan, sites, tr: TrajState, x0, eps):
        """Hybrid rollout at per-scenario step eps [B]
        (SinglePhase.cpp:182-233 + MultiPhaseDDP.cpp:49-92 flattened)."""
        sd, kd = plan.step, plan.knot
        e = eps[:, None, None]
        ka = kd.active[:, None]
        if multiple_shooting:
            X = tr.Xbar + e * tr.dX
            dx = X[:, :-1] - tr.Xbar[:, :-1]
            U = tr.Ubar + e * tr.dU + _mv(tr.K, dx)
            Xn, Y = step_sim(plan, sites, X[:, :-1], U, sd)
            Xn = torch.where(sd.active[:, None] > 0, Xn, X[:, 1:])
            Xsim = torch.cat([x0[:, None], Xn], dim=1)
        else:
            # sequential single-shooting rollout (option.MS == false,
            # SinglePhase.cpp:182-233 with an empty shooting-state set):
            # the step-sim select at every step, inactive steps hold x
            x, Xs, Us, Ys = x0, [x0], [], []
            for k in range(plan.n_steps):
                sd_k = StepData(*[a[k:k + 1] for a in sd])
                u = tr.Ubar[:, k] + eps[:, None] * tr.dU[:, k] \
                    + _mv(tr.K[:, k], x - tr.Xbar[:, k])
                xn, y = step_sim(plan, None, x[:, None], u[:, None], sd_k)
                x = torch.where(sd.active[k] > 0, xn[:, 0], x)
                Xs.append(x)
                Us.append(u)
                Ys.append(y[:, 0])
            X = torch.stack(Xs, 1)
            U = torch.stack(Us, 1)
            Y = torch.stack(Ys, 1)
            Xsim = X
        Defect = (Xsim - X) * ka
        ok = torch.isfinite(Xsim).all(dim=(1, 2)) & (
            torch.sum((Xsim * ka) ** 2, dim=-1).amax(dim=1) < 1e12)
        return tr._replace(X=X, U=U, Y=Y, Xsim=Xsim, Defect=Defect), ok

    # ---------------- cost -------------------------------------------
    def cost_terms(plan, tr: TrajState):
        """Penalty-independent cost pieces: quadratic (tracking+terminal)
        cost [B] and raw constraint values g [B, N, nc], h [B, N+1, nt]."""
        sd, kd = plan.step, plan.knot
        Xs = tr.X[:, :-1]
        run_mask = sd.active * (1.0 - sd.is_reset)
        term_mask = kd.active * kd.is_terminal
        N = plan.n_steps
        l = _fan_out(fns, "run_cost", N)(Xs, tr.U, tr.Y, sd)
        g = _fan_out(fns, "path_con", N)(Xs, tr.U, tr.Y, sd)
        h = _fan_out(fns, "term_con", N, 1)(tr.X, kd)
        phi = _fan_out(fns, "term_cost", N, 1)(tr.X, kd)
        cq = torch.sum(l * run_mask, 1) + torch.sum(phi * term_mask, 1)
        return cq, g, h

    def cost_from_terms(plan, pen: PenaltyParams, cq, g, h):
        """Fold ReB/AL penalties over cached cost terms
        (SinglePhase.cpp:236-262) + max constraint violations."""
        sd, kd = plan.step, plan.knot
        run_mask = sd.active * (1.0 - sd.is_reset)
        term_mask = kd.active * kd.is_terminal
        total = cq
        if opts.ReB_active:
            reb = penalty.reb_cost(g, pen.reb_delta, pen.reb_eps,
                                   pen.reb_active)
            total = total + torch.sum(sd.dt * reb * run_mask, 1)
        if opts.AL_active:
            al = penalty.al_cost(h, pen.al_lambda, pen.al_sigma,
                                 pen.al_active)
            total = total + torch.sum(al * term_mask, 1)
        # violations: path g>=0 feasible (max_pconstr <= 0);
        # terminal |h| (max_tconstr >= 0)
        g_act = (pen.reb_active > 0) & (run_mask[:, None] > 0)
        max_p = torch.where(g_act, g, torch.zeros_like(g)).amin(dim=(1, 2))
        max_p = torch.clamp(max_p, max=0.0)
        h_act = (pen.al_active > 0) & (term_mask[:, None] > 0)
        max_t = torch.where(h_act, h.abs(), torch.zeros_like(h)) \
            .amax(dim=(1, 2))
        return total, max_p, max_t

    def dyn_feas(Defect):
        return torch.sqrt(torch.sum(Defect ** 2, dim=(1, 2)))

    def forward(plan, sites, pen, tr, x0, eps):
        """One trial at per-scenario step eps [B]: the fused trial hook, or
        rollout + cost terms + penalty folding.  Returns (tr2, (cq, g, h),
        cost, feas, maxp, maxt, ok)."""
        if fused_forward is not None:
            return fused_forward(plan, pen, tr, x0, eps, plain_ops=plain_ops)
        tr2, ok = rollout(plan, sites, tr, x0, eps)
        cq, g, h = cost_terms(plan, tr2)
        cost, maxp, maxt = cost_from_terms(plan, pen, cq, g, h)
        return tr2, (cq, g, h), cost, dyn_feas(tr2.Defect), maxp, maxt, ok

    # ---------------- LQ approximation -------------------------------
    def lq_approx(plan, sites, pen, tr: TrajState):
        """(SinglePhase.cpp:265-320), all knots and scenarios at once."""
        sd, kd = plan.step, plan.knot
        N = plan.n_steps
        ch = lq_knot_chunk
        Xs = tr.X[:, :-1]
        A, B, C, D = _fan_out(fns, "dyn_partials", N, chunk=ch)(
            Xs, tr.U, sd)
        if sites is None:
            P = _fan_out(fns, "reset_partial", N)(Xs, sd)
            is_r = sd.is_reset[:, None, None] > 0
            A = torch.where(is_r, P, A)
            B = torch.where(is_r, torch.zeros_like(B), B)
        for st in sites or ():
            P = st.fns.reset_partial(tr.X[:, st.idx], st.sd)
            vm = st.valid[:, None, None]
            A = A.index_copy(1, st.idx, torch.where(vm, P, A[:, st.idx]))
            B = B.index_copy(1, st.idx, torch.where(vm, 0.0, B[:, st.idx]))
        act = sd.active[:, None, None]
        A = A * act
        B = B * act
        C = C * ((1.0 - sd.is_reset)[:, None, None] * act)
        D = D * ((1.0 - sd.is_reset)[:, None, None] * act)

        lx, lu, ly, lxx, luu, lux, lyy = _fan_out(
            fns, "run_cost_partials", N, chunk=ch)(Xs, tr.U, tr.Y, sd)
        if opts.ReB_active:
            g = _fan_out(fns, "path_con", N)(Xs, tr.U, tr.Y, sd)
            gx, gu, gy = _fan_out(fns, "path_con_partials", N, chunk=ch)(
                Xs, tr.U, tr.Y, sd)
            rb = penalty.reb_partials(g, gx, gu, gy, pen.reb_delta,
                                      pen.reb_eps, pen.reb_active)
            dt = sd.dt[:, None]
            lx = lx + dt * rb[0]
            lu = lu + dt * rb[1]
            ly = ly + dt * rb[2]
            dt = dt[..., None]
            lxx = lxx + dt * rb[3]
            luu = luu + dt * rb[4]
            lyy = lyy + dt * rb[5]

        phix, phixx = _fan_out(fns, "term_cost_partials", N, 1)(tr.X, kd)
        if opts.AL_active:
            h = _fan_out(fns, "term_con", N, 1)(tr.X, kd)
            hx = _fan_out(fns, "term_con_partials", N, 1)(tr.X, kd)
            ag, ah = penalty.al_partials(h, hx, pen.al_lambda, pen.al_sigma,
                                         pen.al_active)
            phix = phix + ag
            phixx = phixx + ah
        tmask = (kd.active * kd.is_terminal)[:, None]
        rmask = (sd.active * (1.0 - sd.is_reset))[:, None]
        rmask2 = rmask[..., None]
        return tr._replace(
            A=A, B=B, C=C, D=D,
            lx=lx * rmask, lu=lu * rmask, ly=ly * rmask,
            lxx=lxx * rmask2, luu=luu * rmask2, lux=lux * rmask2,
            lyy=lyy * rmask2,
            phix=phix * tmask, phixx=phixx * tmask[..., None])

    # ---------------- backward sweep ----------------------------------
    # Each sweep takes (plan, tr, reg [B], ops) and returns the outputs
    # (G, H, K, dU, Qu, Quu, Qux) and dV1, dV2, ok [B]; ops are the
    # regularization-invariant operands (sweep_operands) of the kernel.
    def transform_steps(plan):
        sd = plan.step
        return (sd.is_reset > 0) | (sd.active == 0)

    def backward_sweep(plan, tr: TrajState, reg, ops=None):
        """Reverse recursion (SinglePhase.cpp:323-391 +
        MultiPhaseDDP.cpp:174-213 unified: dynamics step | reset/padding
        transform), with the exact Cholesky of Quu - 1e-9 I
        (hsddp.py:623-687)."""
        Bsz, N = tr.Ubar.shape[:2]
        us = tr.Ubar.shape[-1]
        xs = tr.Xbar.shape[-1]
        dtype, dev = tr.Xbar.dtype, tr.Xbar.device
        I_u = torch.eye(us, dtype=dtype, device=dev)
        I_x = torch.eye(xs, dtype=dtype, device=dev)
        regm = reg[:, None, None]
        w = transform_steps(plan)
        G1, H1 = tr.phix[:, -1], tr.phixx[:, -1]
        dV1 = tr.Xbar.new_zeros(Bsz)
        dV2 = tr.Xbar.new_zeros(Bsz)
        ok = torch.ones(Bsz, dtype=torch.bool, device=dev)
        outs = []
        for k in reversed(range(N)):
            A, B, C, D = tr.A[:, k], tr.B[:, k], tr.C[:, k], tr.D[:, k]
            AT, BT, CT, DT = _t(A), _t(B), _t(C), _t(D)
            ly, lyy = tr.ly[:, k], tr.lyy[:, k]
            Gn = G1 + _mv(H1, tr.Defect[:, k + 1])
            # --- dynamics-step branch
            Qx = tr.lx[:, k] + _mv(AT, Gn) + _mv(CT, ly)
            Qu = tr.lu[:, k] + _mv(BT, Gn) + _mv(DT, ly)
            Qxx = tr.lxx[:, k] + AT @ H1 @ A + CT @ lyy @ C
            Quu = tr.luu[:, k] + BT @ H1 @ B + DT @ lyy @ D
            Qux = tr.lux[:, k] + BT @ H1 @ A + DT @ lyy @ C
            Qxx = Qxx + I_x * regm
            Quu = Quu + I_u * regm
            L, ok_k = _cholesky_ok(Quu - 1e-9 * I_u)
            L_safe = torch.where(ok_k[:, None, None], L, I_u)
            Quu_inv = torch.cholesky_solve(I_u.expand_as(L), L_safe)
            Qxx = 0.5 * (Qxx + _t(Qxx))
            dU = -_mv(Quu_inv, Qu)
            K = -(Quu_inv @ Qux)
            G_dyn = Qx - _mv(_t(Qux), _mv(Quu_inv, Qu))
            H_dyn = Qxx - _t(Qux) @ (Quu_inv @ Qux)
            dV_k = -torch.sum(Qu * dU, -1)
            # --- reset/padding transform branch
            G_tr = tr.phix[:, k] + _mv(AT, Gn)
            H_tr = tr.phixx[:, k] + AT @ H1 @ A
            wk = w[k]
            G1 = torch.where(wk, G_tr, G_dyn)
            H1 = torch.where(wk, H_tr, H_dyn)
            dV_k = torch.where(wk, 0.0, dV_k)
            dV1 = dV1 - dV_k
            dV2 = dV2 + dV_k
            ok = ok & (ok_k | wk)
            outs.append((G1, H1, torch.where(wk, 0.0, K),
                         torch.where(wk, 0.0, dU), torch.where(wk, 0.0, Qu),
                         torch.where(wk, I_u, Quu),
                         torch.where(wk, 0.0, Qux)))
        G, H, K, dU, Qu, Quu, Qux = (torch.stack(o[::-1], dim=1)
                                     for o in zip(*outs))
        G = torch.cat([G, tr.phix[:, -1:]], dim=1)
        H = torch.cat([H, tr.phixx[:, -1:]], dim=1)
        # value gradient defect correction at the initial knot
        # (SinglePhase.cpp:389)
        G[:, 0] = G[:, 0] + _mv(H[:, 0], tr.Defect[:, 0])
        return (G, H, K, dU, Qu, Quu, Qux), dV1, dV2, ok

    def backward_sweep_parallel(plan, tr: TrajState, reg, ops=None):
        """Parallel-in-time Riccati sweep (hsddp.py:689-715): each step's
        value-function backward map is a linear fractional transform
        (A, b, C, eta, J) with an associative composition; the suffix
        compositions of an associative scan over the knots give every
        knot's (G, H) in O(log N) depth, and the gains and Q-expansions
        follow knot-parallel.  The same outputs, PSD flag included, as the
        sequential sweep."""
        w = transform_steps(plan)
        elems, (lx, lu, lxx, luu, lux) = riccati_lft_elements(
            tr.A, tr.B, tr.C, tr.D, tr.lx, tr.lu, tr.ly, tr.lxx, tr.luu,
            tr.lux, tr.lyy, tr.phix, tr.phixx, tr.Defect, w, reg)
        _, _, _, G, H = associative_scan(lft_combine, elems, dim=1,
                                         reverse=True)
        return gains_from_GH(tr, G, H, lu, luu, lux, w)

    def gains_from_GH(tr, G, H, lu, luu, lux, w):
        """Knot-parallel Q-expansion and gains from (G, H) (the sequential
        sweep's formulas, SinglePhase.cpp:334-386; hsddp.py:717-747)."""
        us = tr.Ubar.shape[-1]
        I_u = torch.eye(us, dtype=tr.Xbar.dtype, device=tr.Xbar.device)
        Gn = G[:, 1:] + _mv(H[:, 1:], tr.Defect[:, 1:])
        Qu = lu + torch.einsum("bkji,bkj->bki", tr.B, Gn)
        Quu = luu + torch.einsum("bkji,bkjl,bklm->bkim", tr.B, H[:, 1:],
                                 tr.B)
        Qux = lux + torch.einsum("bkji,bkjl,bklm->bkim", tr.B, H[:, 1:],
                                 tr.A)
        L, ok_chol = _cholesky_ok(Quu - 1e-9 * I_u)
        ok_k = ok_chol | w
        L_safe = torch.where(ok_chol[..., None, None], L, I_u)
        Quu_inv = torch.cholesky_solve(I_u.expand_as(L), L_safe)
        dU = -_mv(Quu_inv, Qu)
        K = -(Quu_inv @ Qux)
        dV_k = -torch.sum(Qu * dU, -1) * (1.0 - w.to(Qu.dtype))
        dV1 = -torch.sum(dV_k, 1)
        dV2 = torch.sum(dV_k, 1)
        wv = w[:, None]
        wm = w[:, None, None]
        K = torch.where(wm, 0.0, K)
        dU = torch.where(wv, 0.0, dU)
        Qu = torch.where(wv, 0.0, Qu)
        Quu = torch.where(wm, I_u, Quu)
        Qux = torch.where(wm, 0.0, Qux)
        ok = ok_k.all(1) & torch.isfinite(H).all(dim=(1, 2, 3))
        G = G.clone()
        G[:, 0] = G[:, 0] + _mv(H[:, 0], tr.Defect[:, 0])
        return (G, H, K, dU, Qu, Quu, Qux), dV1, dV2, ok

    def backward_sweep_knot(plan, tr: TrajState, reg, ops=None):
        """Knot-sharded (sequence-parallel) sweep (hsddp.py:749-784): the
        parallel sweep's LFT elements, padded with identity elements to a
        multiple of knot_shards, composed by the two-level suffix scan over
        the blocks (parallel/knot_riccati.py), then the gains
        knot-parallel."""
        from cafempc_tpu_torch.parallel.knot_riccati import (
            pad_elements, sharded_suffix_GH)
        w = transform_steps(plan)
        elems, (lx, lu, lxx, luu, lux) = riccati_lft_elements(
            tr.A, tr.B, tr.C, tr.D, tr.lx, tr.lu, tr.ly, tr.lxx, tr.luu,
            tr.lux, tr.lyy, tr.phix, tr.phixx, tr.Defect, w, reg)
        elems_p, N1 = pad_elements(elems, knot_shards)
        G, H = sharded_suffix_GH(
            elems_p, knot_devices if knot_devices is not None
            else [tr.Xbar.device] * knot_shards)
        return gains_from_GH(tr, G[:, :N1], H[:, :N1], lu, luu, lux, w)

    def sweep_operands(plan, tr: TrajState):
        """Sweep-kernel operands, invariant across the regularization
        retries: the output-equation terms folded into the cost
        expansions, and the mutually exclusive cost streams merged
        (transform steps read phix/phixx, dynamics steps lx/lxx)."""
        lx, lu, lxx, luu, lux = tr.lx, tr.lu, tr.lxx, tr.luu, tr.lux
        if tr.ly.shape[-1]:
            lx = lx + torch.einsum("bkij,bki->bkj", tr.C, tr.ly)
            lu = lu + torch.einsum("bkij,bki->bkj", tr.D, tr.ly)
            lxx = lxx + torch.einsum("bkji,bkjl,bklm->bkim",
                                     tr.C, tr.lyy, tr.C)
            luu = luu + torch.einsum("bkji,bkjl,bklm->bkim",
                                     tr.D, tr.lyy, tr.D)
            lux = lux + torch.einsum("bkji,bkjl,bklm->bkim",
                                     tr.D, tr.lyy, tr.C)
        wb = transform_steps(plan)
        lx_m = torch.where(wb[:, None], tr.phix[:, :-1], lx)
        lxx_m = torch.where(wb[:, None, None], tr.phixx[:, :-1], lxx)
        return (tr.A.contiguous(), tr.B.contiguous(), lx_m.contiguous(),
                lu.contiguous(), lxx_m.contiguous(), luu.contiguous(),
                lux.contiguous(), tr.phix[:, -1].contiguous(),
                tr.phixx[:, -1].contiguous(), tr.Defect.contiguous(),
                wb.to(torch.int32))

    def backward_sweep_fused(plan, tr: TrajState, reg, ops):
        """One sweep through the sweep kernel (ops.sweep) with the Pallas
        kernel's pivot rule."""
        G_s, H_s, K, dU, Qu, Quu, Qux, ok_f, dv = sweep_kernel(*ops, reg)
        G = torch.cat([G_s, tr.phix[:, -1:]], dim=1)
        H = torch.cat([H_s, tr.phixx[:, -1:]], dim=1)
        G[:, 0] = G[:, 0] + _mv(H[:, 0], tr.Defect[:, 0])
        ok = (ok_f > 0.5) & torch.isfinite(H).all(dim=(1, 2, 3))
        return (G, H, K, dU, Qu, Quu, Qux), dv[:, 0], dv[:, 1], ok

    sweep_fn = (backward_sweep_knot if knot_axis is not None
                else backward_sweep_fused if fused_riccati
                else backward_sweep_parallel if parallel_riccati
                else backward_sweep)

    def backward_sweep_regularized(plan, tr, reg0, alive):
        """Regularization retry loop (MultiPhaseDDP.cpp:136-165)."""
        ops = sweep_operands(plan, tr) if fused_riccati else None
        if reg_floor:
            reg0 = torch.clamp(reg0, min=reg_floor)
        zero = torch.zeros_like(reg0)
        c = ((tr.G, tr.H, tr.K, tr.dU, tr.Qu, tr.Quu, tr.Qux), reg0,
             torch.zeros_like(alive), zero, zero,
             torch.zeros_like(alive, dtype=torch.int32))

        def cond(c):
            _, reg, ok, _, _, it = c
            return alive & (~ok) & (reg <= opts.reg_max) & (it < 32)

        active = cond(c)
        n_act = _n_set(active)
        while n_act:
            outs, reg, _, _, _, it = c
            outs2, dV1, dV2, ok2 = sweep_fn(plan, tr, reg, ops)
            reg2 = torch.where(
                ok2, reg, torch.clamp(reg * opts.update_regularization,
                                      min=opts.reg_min_init))
            c = tree_where(active, (outs2, reg2, ok2, dV1, dV2, it + 1), c,
                           n_act)
            active = cond(c)
            n_act = _n_set(active)
        outs, reg, ok, dV1, dV2, n_it = c
        tr = tr._replace(G=outs[0], H=outs[1], K=outs[2], dU=outs[3],
                         Qu=outs[4], Quu=outs[5], Qux=outs[6])
        reg = reg / 20.0
        reg = torch.where(reg < 1e-6, torch.zeros_like(reg), reg)
        return tr, reg, ok, dV1, dV2, n_it

    # ---------------- linear rollout ----------------------------------
    def _lin_dV(plan, tr: TrajState, dX, eps):
        """Expected cost change along the search direction (shared by the
        scan and kernel rollouts; SinglePhase.cpp:160-175)."""
        w1 = 1.0 - transform_steps(plan).to(dX.dtype)
        dxk = dX[:, :-1]
        duk = eps * tr.dU + _mv(tr.K, dxk)
        dV1_dyn = torch.sum(w1 * (torch.sum(tr.lx * dxk, -1)
                                  + torch.sum(tr.lu * duk, -1)), 1)
        dV2_dyn = torch.sum(w1 * (_quad(dxk, tr.lxx, dxk)
                                  + _quad(duk, tr.luu, duk)
                                  + _quad(duk, tr.lux, dxk)), 1)
        dV1_tr = torch.sum(tr.phix * dX, dim=(1, 2))
        dV2_tr = torch.sum(_quad(dX, tr.phixx, dX), 1)
        return dV1_dyn + dV1_tr, dV2_dyn + dV2_tr

    def linroll_operands(plan, tr: TrajState, eps):
        """The affine recursion dx_{k+1} = M_k dx_k + c_k: M = A + BK on
        dynamics steps, A (the reset partial, or 0) otherwise; and dx0."""
        w = transform_steps(plan)[:, None, None]
        M = torch.where(w, tr.A, tr.A + tr.B @ tr.K)
        Bdu = _mv(tr.B, eps * tr.dU)
        c = torch.where(w[..., 0], torch.zeros_like(Bdu), Bdu) \
            + eps * tr.Defect[:, 1:]
        return M, c, eps * tr.Defect[:, 0]

    def linear_rollout_fused(plan, tr: TrajState, eps):
        """Search direction through the linroll kernel
        (SinglePhase.cpp:145-178 + MultiPhaseDDP.cpp:12-42)."""
        M, c, dx0 = linroll_operands(plan, tr, eps)
        dX_tail = linroll_kernel(M.contiguous(), c.contiguous(),
                                 dx0.contiguous())
        dX = torch.cat([dx0[:, None], dX_tail], dim=1)
        dV1, dV2 = _lin_dV(plan, tr, dX, eps)
        return tr._replace(dX=dX), dV1, dV2

    def linear_rollout_parallel(plan, tr: TrajState, eps):
        """Associative-scan linear rollout (hsddp.py:895-921): the prefix
        compositions (M2, c2) o (M1, c1) = (M2 M1, M2 c1 + c2) in O(log N)
        depth, then dX[k+1] = (M_k ... M_0) dx0 + the accumulated c."""
        M, c, dx0 = linroll_operands(plan, tr, eps)
        Mc, cc = associative_scan(
            lambda a, b: (b[0] @ a[0], _mv(b[0], a[1]) + b[1]), (M, c),
            dim=1)
        dX_tail = torch.einsum("bkij,bj->bki", Mc, dx0) + cc
        dX = torch.cat([dx0[:, None], dX_tail], dim=1)
        dV1, dV2 = _lin_dV(plan, tr, dX, eps)
        return tr._replace(dX=dX), dV1, dV2

    def linear_rollout_seq(plan, tr: TrajState, eps):
        """Sequential multiple-shooting search direction and expected cost
        change (SinglePhase.cpp:145-178 + MultiPhaseDDP.cpp:12-42;
        hsddp.py:923-956)."""
        w = transform_steps(plan)
        dx = eps * tr.Defect[:, 0]
        dV1 = tr.Xbar.new_zeros(dx.shape[0])
        dV2 = tr.Xbar.new_zeros(dx.shape[0])
        dXs = [dx]
        for k in range(plan.n_steps):
            A, B = tr.A[:, k], tr.B[:, k]
            du = eps * tr.dU[:, k] + _mv(tr.K[:, k], dx)
            d1 = eps * tr.Defect[:, k + 1]
            dx_dyn = _mv(A, dx) + _mv(B, du) + d1
            dx_tr = _mv(A, dx) + d1
            dV1_dyn = torch.sum(tr.lx[:, k] * dx, -1) \
                + torch.sum(tr.lu[:, k] * du, -1)
            dV2_dyn = _quad(dx, tr.lxx[:, k], dx) \
                + _quad(du, tr.luu[:, k], du) + _quad(du, tr.lux[:, k], dx)
            dV1_tr = torch.sum(tr.phix[:, k] * dx, -1)
            dV2_tr = _quad(dx, tr.phixx[:, k], dx)
            wk = w[k]
            dx = torch.where(wk, dx_tr, dx_dyn)
            dV1 = dV1 + torch.where(wk, dV1_tr, dV1_dyn)
            dV2 = dV2 + torch.where(wk, dV2_tr, dV2_dyn)
            dXs.append(dx)
        # terminal contribution at the final knot
        dV1 = dV1 + torch.sum(tr.phix[:, -1] * dx, -1)
        dV2 = dV2 + _quad(dx, tr.phixx[:, -1], dx)
        return tr._replace(dX=torch.stack(dXs, 1)), dV1, dV2

    linear_rollout = (linear_rollout_fused if fused_linroll
                      else linear_rollout_parallel
                      if parallel_linear_rollout else linear_rollout_seq)

    # ---------------- line search -------------------------------------
    def line_search(plan, sites, pen, tr, x0, merit0, feas0, rho, dV1, dV2,
                    cost0, terms_nom, alive):
        """Sequential backtracking (MultiPhaseDDP.cpp:95-133) with a
        per-scenario step eps."""
        roll0 = (tr.X, tr.U, tr.Y, tr.Xsim, tr.Defect)
        c = (roll0, terms_nom, torch.ones_like(cost0),
             torch.zeros_like(alive, dtype=torch.int32),
             torch.zeros_like(alive), cost0, feas0, merit0)

        def cond(c):
            _, _, _, it, success, _, _, _ = c
            return alive & (~success) & (it < n_trials)

        active = cond(c)
        n_act = _n_set(active)
        while n_act:
            _, _, eps, it, _, _, _, _ = c
            tr2, (cq2, g2, h2), cost2, feas2, _, _, ok = forward(
                plan, sites, pen, tr, x0, eps)
            merit2 = cost2 + rho * feas2
            exp_cost = eps * dV1 + 0.5 * eps * eps * dV2
            exp_merit = exp_cost - eps * rho * feas0
            succ = (merit2 <= merit0 + opts.gamma * exp_merit) & ok
            eps2 = torch.where(succ, eps, eps * opts.alpha)
            roll2 = (tr2.X, tr2.U, tr2.Y, tr2.Xsim, tr2.Defect)
            c = tree_where(active, (roll2, (cq2, g2, h2), eps2, it + 1, succ,
                                    cost2, feas2, merit2), c, n_act)
            active = cond(c)
            n_act = _n_set(active)
        roll, terms, _, n_it, success, cost, feas, merit = c
        tr = tr._replace(X=roll[0], U=roll[1], Y=roll[2], Xsim=roll[3],
                         Defect=roll[4])
        return tr, terms, success, cost, feas, merit, n_it

    def line_search_parallel(plan, sites, pen, tr, x0, merit0, feas0, rho,
                             dV1, dV2, cost0, terms_nom, alive):
        """Batched-candidate line search (hsddp.py:1013-1045): every eps
        the sequential search could try (1, alpha, alpha^2, ...), for every
        scenario, in one rollout at batch n_ls * B (candidate-major), then
        per scenario the first accepted candidate, else the last; the
        trajectory the sequential search accepts, and its trial count."""
        Bsz = x0.shape[0]
        init = ((tr.X, tr.U, tr.Y, tr.Xsim, tr.Defect), terms_nom,
                torch.zeros_like(alive), cost0, feas0, merit0,
                torch.zeros_like(alive, dtype=torch.int32))
        n_alive = _n_set(alive)
        if not n_alive:
            roll, terms, success, cost, feas, merit, n_it = init
        else:
            eps_c = opts.alpha ** torch.arange(n_ls, dtype=x0.dtype,
                                               device=x0.device)

            def rep(t):
                return t.repeat((n_ls,) + (1,) * (t.dim() - 1))

            tr_c = tr._replace(Xbar=rep(tr.Xbar), dX=rep(tr.dX),
                               Ubar=rep(tr.Ubar), dU=rep(tr.dU),
                               K=rep(tr.K))
            tr2, terms2, cost, feas, _, _, ok = forward(
                plan, sites, type(pen)(*map(rep, pen)), tr_c, rep(x0),
                eps_c.repeat_interleave(Bsz))

            def per(t):
                return t.view((n_ls, Bsz) + t.shape[1:])

            e = eps_c[:, None]
            cost, feas, ok = per(cost), per(feas), per(ok)
            merit = cost + rho * feas
            exp_cost = e * dV1 + 0.5 * e * e * dV2
            exp_merit = exp_cost - e * rho * feas0
            succ = (merit <= merit0 + opts.gamma * exp_merit) & ok
            any_ok = succ.any(0)
            # first accepted candidate, else the last tried (the reference
            # leaves the smallest-eps trial in the working trajectory)
            idx = torch.where(any_ok, succ.to(torch.int64).argmax(0),
                              n_ls - 1)
            b = torch.arange(Bsz, device=x0.device)

            def pick(t):
                return per(t)[idx, b]

            new = ((pick(tr2.X), pick(tr2.U), pick(tr2.Y), pick(tr2.Xsim),
                    pick(tr2.Defect)), tuple(map(pick, terms2)), any_ok,
                   cost[idx, b], feas[idx, b], merit[idx, b],
                   torch.where(any_ok, idx + 1, n_ls).to(torch.int32))
            roll, terms, success, cost, feas, merit, n_it = tree_where(
                alive, new, init, n_alive)
        tr = tr._replace(X=roll[0], U=roll[1], Y=roll[2], Xsim=roll[3],
                         Defect=roll[4])
        return tr, terms, success, cost, feas, merit, n_it

    ls_fn = line_search_parallel if parallel_line_search else line_search

    # ---------------- solve -------------------------------------------
    def update_nominal(tr: TrajState):
        return tr._replace(Xbar=tr.X, Ubar=tr.U, Defect_bar=tr.Defect)

    def push_info(info: SolverInfo, cost, feas, maxt, maxp):
        i = torch.clamp(info.n_entries, max=info_len - 1).long()[:, None]

        def put(buf, v):
            return buf.scatter(1, i, v[:, None])

        return info._replace(
            cost_buf=put(info.cost_buf, cost),
            dyn_feas_buf=put(info.dyn_feas_buf, feas),
            eqn_feas_buf=put(info.eqn_feas_buf, maxt),
            ineq_feas_buf=put(info.ineq_feas_buf, maxp),
            n_entries=info.n_entries + 1)

    def ddp_inner(plan, sites, s: SolverState, alive):
        """One inner DDP iteration (MultiPhaseDDP.cpp:277-387) for the
        scenarios in `alive` (the others' results are discarded by the
        caller, so their inner loops need not run)."""
        tr = s.traj
        cost, maxp, maxt = cost_from_terms(plan, s.pen, s.cost_quad,
                                           s.con_g, s.con_h)
        feas = dyn_feas(tr.Defect)
        with tracing.span("hsddp.lq", device=alive):
            if fused_lq is not None:
                tr = fused_lq(plan, s.pen, tr, plain_ops=plain_ops)
            else:
                tr = lq_approx(plan, sites, s.pen, tr)
        with tracing.span("hsddp.sweep", device=alive):
            tr, reg, ok, dV1, dV2, reg_it = backward_sweep_regularized(
                plan, tr, s.reg, alive)
        if opts.MS:
            with tracing.span("hsddp.linroll", device=alive):
                tr, dV1, dV2 = linear_rollout(plan, tr, 1.0)
        dV_abs = torch.abs(dV1 + 0.5 * dV2)
        rho = torch.where(
            feas > opts.dynamics_feas_thresh,
            dV_abs / ((1.0 - opts.merit_scale) * feas) + opts.merit_offset,
            torch.zeros_like(feas))
        merit = cost + rho * feas
        early = (dV_abs < opts.cost_thresh) & \
                (feas <= opts.dynamics_feas_thresh)
        terms_nom = (s.cost_quad, s.con_g, s.con_h)
        # the reference skips the line search on early termination
        # (MultiPhaseDDP.cpp:330-345); its results would be discarded
        with tracing.span("hsddp.line_search", device=alive):
            tr2, terms2, ls_ok, cost2, feas2, merit2, ls_it = ls_fn(
                plan, sites, s.pen, tr, s.x0, merit, feas, rho, dV1, dV2,
                cost, terms_nom, alive & ~early)
        ls_ok = ls_ok & (~early)
        tr2 = tree_where(ls_ok, update_nominal(tr2), tr2)
        tr2 = tree_where(early, tr, tr2)
        cost3 = torch.where(ls_ok, cost2, cost)
        merit3 = torch.where(ls_ok, merit2, merit)
        feas3 = torch.where(ls_ok, feas2, feas)
        terms3 = tree_where(ls_ok, terms2, terms_nom)
        # late termination (MultiPhaseDDP.cpp:369-370)
        denom = torch.where(cost == 0, torch.ones_like(cost), cost)
        late = (torch.abs((cost - cost3) / denom) < opts.cost_thresh) & \
               (feas3 <= opts.dynamics_feas_thresh)
        inner_done = early | late
        info = s.info._replace(
            reg_iters=s.info.reg_iters + reg_it, iters=s.info.iters + 1,
            ls_iters=s.info.ls_iters + torch.where(
                early, torch.zeros_like(ls_it), ls_it))
        info = push_info(info, cost3, feas3, maxt, maxp)
        return s._replace(
            traj=tr2, cost=cost3, merit=merit3, merit_rho=rho, feas=feas3,
            dV1=dV1, dV2=dV2, reg=reg, max_pconstr=maxp, max_tconstr=maxt,
            cost_quad=terms3[0], con_g=terms3[1], con_h=terms3[2],
            success=s.success & ok, info=info), inner_done | (~ok)

    def outer_body(plan, sites, s: SolverState, alive):
        """One AL outer iteration (MultiPhaseDDP.cpp:264-427)."""
        s = s._replace(max_pconstr_prev=s.max_pconstr,
                       max_tconstr_prev=s.max_tconstr,
                       reg=torch.zeros_like(s.cost))
        it = torch.zeros_like(alive, dtype=torch.int32)
        done = torch.zeros_like(alive)
        active = alive & (it < opts.max_DDP_iter)
        n_act = _n_set(active)
        while n_act:
            with tracing.span("hsddp.inner"):
                s2, done2 = ddp_inner(plan, sites, s, active)
                s = tree_where(active, s2, s, n_act)
            done = torch.where(active, done2, done)
            it = it + active.to(torch.int32)
            active = alive & (it < opts.max_DDP_iter) & ~done
            n_act = _n_set(active)

        # convergence checks (MultiPhaseDDP.cpp:394-405)
        feas_ok = s.feas <= opts.dynamics_feas_thresh
        conv = (s.max_tconstr < opts.tconstr_thresh) & \
               (torch.abs(s.max_pconstr) < opts.pconstr_thresh) & feas_ok
        stall = (torch.abs(s.max_tconstr - s.max_tconstr_prev) < 1e-4) & \
                (torch.abs(s.max_pconstr - s.max_pconstr_prev) < 1e-4) & \
                feas_ok
        done = conv | stall | (~s.success)

        # AL / ReB parameter updates on the cached nominal constraint values
        pen = s.pen
        with tracing.span("hsddp.al_update"):
            if opts.AL_active:
                lam, sig = penalty.al_update_params(
                    s.con_h, pen.al_lambda, pen.al_sigma, pen.al_active,
                    opts.tconstr_thresh, opts.update_penalty,
                    _per_lane(pen.al_sigma_max))
                pen = pen._replace(al_lambda=lam, al_sigma=sig)
            if opts.ReB_active:
                dl, ew = penalty.reb_update_params(
                    s.con_g, pen.reb_delta, pen.reb_eps, pen.reb_active,
                    opts.pconstr_thresh, opts.update_relax, opts.update_ReB,
                    _per_lane(pen.reb_delta_min))
                pen = pen._replace(reb_delta=dl, reb_eps=ew)
        return s._replace(pen=pen, done=done)

    def solve(plan: KnotPlan, pen0: PenaltyParams, x0, Xbar0, Ubar0):
        with tracing.span("hsddp.solve"):
            return run(plan, pen0, x0, Xbar0, Ubar0)

    def run(plan, pen0, x0, Xbar0, Ubar0):
        Bsz, xs = x0.shape
        us = Ubar0.shape[-1]
        ys = plan.step.y_ref.shape[-1]
        # the gathered reset sites of the generic rollout and LQ stages;
        # None: the reset map under a select at every step
        sites = (reset_sites(plan, max_resets, fns)
                 if max_resets is not None
                 and (fused_forward is None or fused_lq is None) else None)
        tr = init_traj(plan, xs, us, ys, Xbar0, Ubar0)
        zero = x0.new_zeros(Bsz)
        izero = torch.zeros(Bsz, dtype=torch.int32, device=x0.device)
        buf = x0.new_zeros(Bsz, info_len)
        info = SolverInfo(cost_buf=buf, dyn_feas_buf=buf, eqn_feas_buf=buf,
                          ineq_feas_buf=buf, n_entries=izero, iters=izero,
                          ls_iters=izero, reg_iters=izero)
        # initial rollout + nominal update (MultiPhaseDDP.cpp:238-261)
        with tracing.span("hsddp.rollout", device=x0):
            tr, (cq, g, h), cost, feas, maxp, maxt, _ = forward(
                plan, sites, pen0, tr, x0, zero)
        tr = update_nominal(tr)
        s = SolverState(
            traj=tr, pen=pen0, x0=x0, cost=cost, merit=zero, merit_rho=zero,
            feas=feas, dV1=zero, dV2=zero, reg=zero,
            max_pconstr=maxp, max_tconstr=maxt,
            max_pconstr_prev=zero, max_tconstr_prev=zero,
            cost_quad=cq, con_g=g, con_h=h,
            success=torch.ones_like(izero, dtype=torch.bool),
            done=torch.zeros_like(izero, dtype=torch.bool),
            info=push_info(info, cost, feas, maxt, maxp))

        it = izero
        active = it < opts.max_AL_iter
        n_act = _n_set(active)
        n_outer = 0
        while n_act:
            with tracing.span("hsddp.outer"):
                s2 = outer_body(plan, sites, s, active)
                # The inner loop's masks are subsets of `active`, so it kept
                # the carry of every scenario outside `active`: there the
                # two sides differ only in the fields that outer_body
                # rewrites for every scenario.  The rest is taken as it is.
                s = tree_where(active, s2, s2._replace(
                    **{f: getattr(s, f) for f in OUTER_REWRITES}), n_act)
            if iter_callback is not None:
                iter_callback(s.traj.Xbar, s.traj.Ubar, n_outer)
            n_outer += 1
            it = it + active.to(torch.int32)
            active = (it < opts.max_AL_iter) & ~s.done
            n_act = _n_set(active)
        if not trim_output:
            return s
        t = s.traj
        return SolveResult(
            Xbar=t.Xbar, Ubar=t.Ubar, K=t.K, Qu=t.Qu, Quu=t.Quu, Qux=t.Qux,
            cost=s.cost, feas=s.feas, max_pconstr=s.max_pconstr,
            max_tconstr=s.max_tconstr, success=s.success, info=s.info)

    solve._rollout = rollout
    solve._lq_approx = lq_approx
    solve._backward_sweep = backward_sweep
    solve._backward_sweep_parallel = backward_sweep_parallel
    solve._backward_sweep_fused = backward_sweep_fused
    solve._backward_sweep_knot = backward_sweep_knot
    return solve

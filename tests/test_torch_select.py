"""The solver's per-scenario select, `hsddp.tree_where`, copies only what
can differ, and a solve with it equals, bit for bit, a solve with the
unconditional select: a `torch.where` over every leaf of every tree,
the outer loop's select over the whole `SolverState` included.

CPU, f64.  The HKD solves of a 0.3 s plan: B=4, two scenarios at the
reference start with their constraints switched off and are done after
one AL outer iteration, two are perturbed, so the fetched masks of the
inner, line-search, sweep and outer loops are mixed as well as uniform;
and B=1, where every fetched mask is uniform.  Both line searches, the
fused hooks on and off (their plain twins on the CPU), and one small
`SegmentedFns` (MHPC cascade) solve.  Every leaf of the trimmed
`SolveResult` and of the untrimmed `SolverState` is compared with
`torch.equal`.  The file imports no jax.
"""
import numpy as np
import pytest
import torch

from cafempc_tpu_torch.convert import from_numpy
from cafempc_tpu_torch.models import hkd, synthetic_robot, wbm
from cafempc_tpu_torch.parallel.mesh import broadcast_batch
from cafempc_tpu_torch.problems import hkd_fused as hf
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference, synthetic_bound_reference_urdf)
from cafempc_tpu_torch.solver import hsddp
from cafempc_tpu_torch.solver.hsddp import SolverState, tree_where
from cafempc_tpu_torch.solver.options import SolverOptions
from cafempc_tpu_torch.utils import tracing
from torch_port_inputs import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F64 = torch.float64
KW = dict(fused_riccati=True, max_resets=16, reg_floor=1e-3)
HKD_OPTS = SolverOptions(max_AL_iter=3, max_DDP_iter=4)
# perturbation scale per scenario; 0: at the reference, constraints off
SCALES = {4: (0.0, 0.05, 0.0, 0.5), 1: (0.05,)}


def _reference_where(mask, new, old, n_set=None):
    """The unconditional select: `torch.where` over every leaf."""
    if isinstance(new, torch.Tensor):
        return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)),
                           new, old)
    vals = [_reference_where(mask, a, b) for a, b in zip(new, old)]
    return type(new)(*vals) if hasattr(new, "_fields") else tuple(vals)


def _hkd_args(B):
    qr = QuadReference(synthetic_bound_reference(duration=1.0))
    qr.initialize(0.3)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(
        qr, hp.HKDConfig(plan_duration=0.3, n_steps_max=40))
    body = torch.zeros(12, dtype=F64)
    body[5] = 0.2486
    qd = hkd.compute_hkd_state(
        body[0:3], body[3:6], torch.tensor([0.0, -0.8, 1.6] * 4, dtype=F64),
        torch.tensor(meta["phases"][0][3], dtype=F64))
    scale = torch.tensor(SCALES[B], dtype=F64)
    x0 = torch.cat([body, qd])[None] + scale[:, None] * torch.as_tensor(
        np.random.default_rng(7).normal(size=(B, 24)))
    plan, pen, Xbar0, Ubar0 = from_numpy((plan_np, pen_np, Xbar0, Ubar0),
                                         "cpu", F64)
    pen = broadcast_batch(pen, B)
    off = (scale == 0)[:, None, None]
    pen = pen._replace(reb_active=torch.where(off, 0.0, pen.reb_active),
                       al_active=torch.where(off, 0.0, pen.al_active))
    return (plan, pen, x0, broadcast_batch(Xbar0, B),
            broadcast_batch(Ubar0, B))


def _hkd(B, hooks, parallel_ls):
    kw = dict(KW, parallel_line_search=parallel_ls)
    if hooks:
        kw.update(fused_forward=hf.make_hkd_fused_forward(),
                  fused_lq=hf.make_hkd_fused_lq())
    return (lambda trim: hsddp.make_solver(
        hp.make_hkd_fns(), HKD_OPTS, trim_output=trim, **kw)), _hkd_args(B)


def _mhpc(tmp_path):
    """The small cascade of test_torch_mhpc_solve.py at B=2, 2 AL x 1 DDP."""
    B = 2
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(0.4)
    cfg = mp.MHPCConfig(plan_dur_wb=0.1, plan_dur_srb=0.2, n_steps_max=24,
                        wb_block=16)
    plan_np, pen_np, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, cfg)
    x0 = wb_state_ref_at(qr, 0.0)[None] \
        + np.random.default_rng(3).normal(0, 0.01, (B, mp.XS))
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), "cpu", F64)
    urdf = synthetic_robot.write_synthetic_quadruped_urdf(str(tmp_path))
    fns = mp.make_mhpc_fns_segmented(cfg, wbm.load_model(urdf, "cpu", F64))
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
    return (lambda trim: hsddp.make_solver(
        fns, opts, trim_output=trim, parallel_line_search=False, **KW)), (
        plan, broadcast_batch(pen, B), x0, broadcast_batch(Xbar0, B),
        broadcast_batch(Ubar0, B))


CASES = {
    "hkd-hooks-B4": lambda tmp: _hkd(4, True, False),
    "hkd-generic-seq-B4": lambda tmp: _hkd(4, False, False),
    "hkd-generic-par-B4": lambda tmp: _hkd(4, False, True),
    "hkd-hooks-B1": lambda tmp: _hkd(1, True, False),
    "hkd-generic-par-B1": lambda tmp: _hkd(1, False, True),
    "mhpc-segmented-B2": _mhpc,
}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_is_bit_identical_to_the_unconditional_select(
        case, tmp_path, monkeypatch):
    """Both solves, trimmed and untrimmed, as built and with the
    unconditional select: every leaf equal.  The built solve passed leaves
    through and fetched the masks the case is meant to cover."""
    make, args = CASES[case](tmp_path)
    fetched = []
    real_n_set = hsddp._n_set
    with monkeypatch.context() as m:
        m.setattr(hsddp, "_n_set", lambda mask: (
            lambda n: fetched.append((n, mask.numel())) or n)(
                real_n_set(mask)))
        tracing.reset()
        tracing.enable()
        try:
            built = [make(trim)(*args) for trim in (True, False)]
        finally:
            tracing.disable()
    counts = tracing.counts()
    tracing.reset()
    with monkeypatch.context() as m:
        m.setattr(hsddp, "tree_where", _reference_where)
        m.setattr(hsddp, "OUTER_REWRITES", SolverState._fields)
        want = [make(trim)(*args) for trim in (True, False)]
    for got, ref in zip(built, want):
        assert type(got) is type(ref)
        a, b = _leaves(got), _leaves(ref)
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == y.dtype and torch.equal(x, y), (case, i)
    skip = sum(c.get("hsddp.select_skip", 0) for c in counts.values())
    copy = sum(c.get("hsddp.select_copy", 0) for c in counts.values())
    assert skip > 0 and any(n == b for n, b in fetched)
    if case.endswith("B1"):
        assert all(n in (0, 1) for n, b in fetched)
    elif case.startswith("hkd"):
        assert any(0 < n < b for n, b in fetched) and copy > 0


def test_outer_mask_is_mixed_after_one_outer_iteration(monkeypatch):
    """The B=4 HKD case reaches its second outer iteration with the two
    reference scenarios done, so the narrowed outer select runs on a mixed
    mask."""
    make, args = _hkd(4, False, False)
    outer = []
    real = hsddp.tree_where

    def spy(mask, new, old, n_set=None):
        if isinstance(new, SolverState) and new.pen is not old.pen:
            outer.append(mask.tolist())
        return real(mask, new, old, n_set)
    monkeypatch.setattr(hsddp, "tree_where", spy)
    make(True)(*args)
    assert outer[0] == [True] * 4
    assert outer[1] == [False, True, False, True]


# ---- tree_where alone -----------------------------------------------------

def _pair(B=3):
    g = torch.Generator().manual_seed(0)
    shared = torch.randn(B, 4, 5, generator=g)
    new = (torch.randn(B, 2, generator=g), shared,
           torch.randn(B, generator=g))
    old = (torch.randn(B, 2, generator=g), shared,
           torch.randn(B, generator=g))
    return new, old


def _count(fn):
    tracing.reset()
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    c = tracing.counts().get(None, {})
    tracing.reset()
    return out, c.get("hsddp.select_skip", 0), c.get("hsddp.select_copy", 0)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _identical_leaf():
    new, old = _pair()
    mask = torch.tensor([True, False, True])
    out, skip, copy = _count(lambda: tree_where(mask, new, old))
    assert out[1] is new[1] and (skip, copy) == (1, 2)
    assert _equal(out, _reference_where(mask, new, old))
    # another view of the same storage, shape and strides passes too
    view = new[1].view(new[1].shape)
    out = tree_where(mask, (view,), (new[1],))
    assert out[0] is view


def _all_set():
    new, old = _pair()
    mask = torch.ones(3, dtype=torch.bool)
    out, skip, copy = _count(lambda: tree_where(mask, new, old, 3))
    assert all(a is b for a, b in zip(out, new)) and (skip, copy) == (3, 0)
    assert _equal(out, _reference_where(mask, new, old))


def _none_set():
    new, old = _pair()
    mask = torch.zeros(3, dtype=torch.bool)
    out, skip, copy = _count(lambda: tree_where(mask, new, old, 0))
    assert all(a is b for a, b in zip(out, old)) and (skip, copy) == (3, 0)
    assert _equal(out, _reference_where(mask, new, old))


def _mixed():
    new, old = _pair()
    mask = torch.tensor([False, True, True])
    out, skip, copy = _count(lambda: tree_where(mask, new, old, 2))
    assert _equal(out, _reference_where(mask, new, old))
    assert out[0] is not new[0] and out[0] is not old[0]
    assert (skip, copy) == (1, 2)


def _one_scenario():
    new, old = _pair(B=1)
    for n in (0, 1):
        mask = torch.tensor([bool(n)])
        out, skip, copy = _count(lambda: tree_where(mask, new, old, n))
        assert all(a is b for a, b in zip(out, new if n else old))
        assert (skip, copy) == (3, 0)


def _dtype_mismatch():
    mask = torch.ones(2, dtype=torch.bool)
    new = (torch.tensor([1, 2], dtype=torch.int32),)
    old = (torch.tensor([0.5, 1.5], dtype=F64),)
    out, skip, copy = _count(lambda: tree_where(mask, new, old, 2))
    want = _reference_where(mask, new, old)
    assert out[0].dtype == want[0].dtype == F64
    assert _equal(out, want) and (skip, copy) == (0, 1)


def _shape_mismatch():
    mask = torch.tensor([True, True])
    new = (torch.arange(2.0)[:, None],)         # [2, 1] broadcast to [2, 3]
    old = (torch.zeros(2, 3),)
    out, skip, copy = _count(lambda: tree_where(mask, new, old, 2))
    want = _reference_where(mask, new, old)
    assert out[0].shape == (2, 3) and _equal(out, want)
    assert (skip, copy) == (0, 1)
    # a leaf the mask would broadcast, identical on both sides, is copied
    t = torch.arange(3.0)[None]                 # [1, 3] against a [2] mask
    out, skip, copy = _count(lambda: tree_where(mask, (t,), (t,)))
    assert out[0].shape == (2, 3) and _equal(out, _reference_where(
        mask, (t,), (t,))) and (skip, copy) == (0, 1)


def _named_tuples():
    new, old = _pair()
    mask = torch.tensor([True, False, False])
    assert type(tree_where(mask, new, old)) is tuple
    info = tree_where(mask, hsddp.SolverInfo(*(new * 3)[:8]),
                      hsddp.SolverInfo(*(old * 3)[:8]))
    assert type(info) is hsddp.SolverInfo


UNITS = dict(identical_leaf=_identical_leaf, all_set=_all_set,
             none_set=_none_set, mixed=_mixed, one_scenario=_one_scenario,
             dtype_mismatch=_dtype_mismatch, shape_mismatch=_shape_mismatch,
             named_tuples=_named_tuples)


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_tree_where(unit):
    """Each rule against the unconditional `torch.where`, and the
    `hsddp.select_skip` / `hsddp.select_copy` counts of each call."""
    UNITS[unit]()

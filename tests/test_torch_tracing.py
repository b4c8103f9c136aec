"""The port's tracer (`utils/tracing.py`) and the spans and counters of
the solver, the whole-body linearization and the HKD runtime.

CPU: B=2 f64 HKD solves of a 0.3 s plan, one through the `hkd` bench
path (fused LQ and trial hooks) and one through the generic stages with
gathered resets, both on the sweep and linroll twins, with the tracer
off, then with it on: off, nothing is recorded; on, one `hsddp.solve`
root a call with every stage under it; the `hsddp.sync` counter equals
the host syncs counted by a monkeypatch; the answers are bit-identical.
An `HKDMPCRuntime` and an `MHPCRuntime` update (a CPU f64 cascade) are
each one `runtime.update` root with its six stages in order, and their
`timing` comes from their clocks.  Both WB partial functions nest their
four stages.  A B=2 f64 barrel-roll solve (1 AL x 1 DDP) off, then on:
its `wb.partials`, `wb.impulse_partials` and `br.td_con` spans fire under
its root, the `wb.cf_knots` counter adds the knots each closed-form
linearization takes, no forward-mode Jacobian is taken, each forward
trial's lane step (`wb.step` spans inside the rollouts) adds its B x 130
steps and B x 16 gathered reset sites to `wb.step_knots`, and the answers
are bit-identical.  A B=2 f64 cascade solve (40 WB and 40 SRB steps, 1 AL
x 1 DDP) off, then on: one `srb.partials` span a call of the SRB tail's
linearization (inside the LQ stage) and one `srb.step` span a call of its
forward step (inside the rollouts), under the solve's root; the counters
`srb.lin_knots` and `srb.step_knots` add the SRB steps x B of each call;
the answers are bit-identical.

On the card (marked `gpu`, skipped without one): the device event pairs
resolve to positive stream ms, and under a profile with CPU and CUDA
activity the spans are `record_function` ranges holding their kernels.
The file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""
import math

import numpy as np
import pytest
import torch

from cafempc_tpu_torch.convert import from_numpy
from cafempc_tpu_torch.models import hkd, rbda, synthetic_robot, wb_lane, wbm
from cafempc_tpu_torch.parallel.mesh import broadcast_batch
from cafempc_tpu_torch.problems import barrel_roll as br
from cafempc_tpu_torch.problems import hkd_fused as hf
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference, synthetic_bound_reference_urdf,
    write_synthetic_br_settings)
from cafempc_tpu_torch.runtime.mhpc_runtime import MHPCRuntime
from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
from cafempc_tpu_torch.solver import hsddp
from cafempc_tpu_torch.solver.options import SolverOptions
from cafempc_tpu_torch.utils import tracing
from torch_port_inputs import one_torch_thread  # noqa: F401 (fixture)

B = 2
PLAN = dict(plan_duration=0.3, n_steps_max=40)
OPTS = SolverOptions(max_AL_iter=2, max_DDP_iter=2)
KW = dict(fused_riccati=True, parallel_line_search=False, max_resets=16,
          reg_floor=1e-3)
# every stage span of a solve on this path, and those with device events
STAGES = {"hsddp.rollout", "hsddp.outer", "hsddp.inner", "hsddp.lq",
          "hsddp.sweep", "hsddp.linroll", "hsddp.line_search",
          "hsddp.select", "hsddp.al_update", "hsddp.sync"}
DEVICE_STAGES = {"hsddp.rollout", "hsddp.lq", "hsddp.sweep",
                 "hsddp.linroll", "hsddp.line_search", "hsddp.select"}
RUNTIME_STAGES = ["runtime.plan", "runtime.warm_start", "runtime.upload",
                  "runtime.solve", "runtime.fetch", "runtime.tape"]
WB_STAGES = ["wb.kin", "wb.kkt_solve", "wb.directions", "wb.tail"]


def _fresh():
    tracing.disable()
    tracing.reset()


@pytest.fixture
def tracer():
    """The tracer, off and empty before and after the test."""
    _fresh()
    yield tracing
    _fresh()


def _qr():
    qr = QuadReference(synthetic_bound_reference(duration=1.0))
    qr.initialize(PLAN["plan_duration"])
    return qr


def _solve_args(device):
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(
        _qr(), hp.HKDConfig(**PLAN))
    f64 = torch.float64
    body = torch.zeros(12, dtype=f64)
    body[5] = 0.2486
    qd = hkd.compute_hkd_state(
        body[0:3], body[3:6], torch.tensor([0.0, -0.8, 1.6] * 4, dtype=f64),
        torch.tensor(meta["phases"][0][3], dtype=f64))
    x0 = torch.cat([body, qd])[None] + 0.01 * torch.as_tensor(
        np.random.default_rng(7).normal(size=(B, 24)))
    plan, pen, Xbar0, Ubar0 = from_numpy((plan_np, pen_np, Xbar0, Ubar0),
                                         device, f64)
    return (plan, broadcast_batch(pen, B), x0.to(device),
            broadcast_batch(Xbar0, B), broadcast_batch(Ubar0, B))


def _solver(hooks=True):
    """The bench path's solver, or (hooks=False) the generic stages."""
    if not hooks:
        return hsddp.make_solver(hp.make_hkd_fns(), OPTS, **KW)
    return hsddp.make_solver(hp.make_hkd_fns(), OPTS,
                             fused_forward=hf.make_hkd_fused_forward(),
                             fused_lq=hf.make_hkd_fused_lq(), **KW)


def _under(spans, root_id):
    return [s for s in spans if s.root == root_id and s.id != root_id]


@pytest.fixture(scope="module")
def traced():
    """Both solvers' solves with the tracer off, then with it on, the host
    syncs counted by wrappers of `_n_set` and `reset_sites` (one fetch a
    segment)."""
    _fresh()
    solvers = [_solver(True), _solver(False)]
    args = _solve_args(torch.device("cpu"))
    off = [solve(*args) for solve in solvers]
    out = dict(off=off, off_spans=tracing.spans(),
               off_counts=tracing.counts(),
               off_span=tracing.span("hsddp.lq", device=args[2]),
               off_count=tracing.count("hsddp.sync"))
    syncs = []
    real_n_set, real_sites = hsddp._n_set, hsddp.reset_sites
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(hsddp, "_n_set",
                      lambda m: syncs.append(1) or real_n_set(m))
        patch.setattr(hsddp, "reset_sites", lambda *a: (
            lambda s: syncs.extend([1] * len(s)) or s)(real_sites(*a)))
        tracing.enable()
        try:
            on, per_call = [], []
            for solve in solvers:
                n0 = len(syncs)
                on.append(solve(*args))
                per_call.append(len(syncs) - n0)
        finally:
            tracing.disable()
    out.update(on=on, syncs=per_call, spans=tracing.spans(),
               counts=tracing.counts())
    _fresh()
    return out


def _case_off(t):
    assert t["off_spans"] == [] and t["off_counts"] == {}
    assert t["off_span"] is tracing.NO_SPAN and t["off_count"] is None


def _case_roots(t):
    spans = t["spans"]
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["hsddp.solve"] * 2
    by_id = {s.id: s for s in spans}
    for r in roots:
        inside = _under(spans, r.id)
        assert STAGES <= {s.name for s in inside}
        assert {s.name for s in inside} <= STAGES
        for s in inside:
            p = by_id[s.parent]
            assert p.root == r.id
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # CPU work records no device events
    assert all(s.device_ms is None for s in spans)
    assert all(s.host_ms >= 0 for s in spans)


def _case_syncs(t):
    roots = [s.id for s in t["spans"] if s.parent is None]
    assert list(t["counts"]) == roots
    got = [t["counts"][r]["hsddp.sync"] for r in roots]
    assert got == t["syncs"] and min(got) > 0
    spanned = [sum(1 for s in _under(t["spans"], r) if s.name == "hsddp.sync")
               for r in roots]
    assert spanned == got


def _case_identical(t):
    for res, off in zip(t["on"], t["off"]):
        for f in ("cost", "Xbar", "Ubar", "K", "success"):
            assert torch.equal(getattr(res, f), getattr(off, f)), f
        for a, b in zip(res.info, off.info):
            assert torch.equal(a, b)


CASES = dict(off=_case_off, roots=_case_roots, syncs=_case_syncs,
             identical=_case_identical)


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_solve(traced, case):
    """Off: nothing recorded, the shared no-op span.  On: one
    `hsddp.solve` root a call with every stage nested under it; the
    `hsddp.sync` counter and spans equal the monkeypatched count of host
    syncs; the same answers bit for bit."""
    CASES[case](traced)


def _hkd_runtime(tmp):
    """An HKDMPCRuntime at the 0.3 s plan, 2 AL, and its initial state."""
    rt = HKDMPCRuntime(_qr(), hp.HKDConfig(**PLAN),
                       SolverOptions(max_AL_iter=2), device="cpu")
    return rt, np.asarray(_solve_args(torch.device("cpu"))[2][0])


def _mhpc_runtime(tmp):
    """An MHPCRuntime on the synthetic quadruped at a small cascade (WB
    0.1 s, SRB 0.2 s), 1 AL x 1 DDP, and the reference's initial
    state."""
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(0.4)
    model = wbm.load_model(synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp)), "cpu", torch.float64)
    rt = MHPCRuntime(qr, mp.MHPCConfig(plan_dur_wb=0.1, plan_dur_srb=0.2,
                                       n_steps_max=24, wb_block=16),
                     SolverOptions(max_AL_iter=1, max_DDP_iter=1),
                     model=model, device="cpu")
    return rt, wb_state_ref_at(qr, 0.0)


@pytest.mark.parametrize("runtime", [_hkd_runtime, _mhpc_runtime],
                         ids=["hkd", "mhpc"])
def test_runtime_update_spans(tracer, tmp_path, one_torch_thread, runtime):
    """An untraced initialize records nothing and still fills `timing`;
    a traced update is one `runtime.update` root with its six stages in
    order, the solve under `runtime.solve`, and `timing` from their
    clocks."""
    rt, x = runtime(tmp_path)
    rt.initialize(x)
    assert tracer.spans() == [] and set(rt.timing) == {
        "build_ms", "solve_ms", "fetch_ms"}
    tracer.enable()
    rt.update(x)
    tracer.disable()
    spans = tracer.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["runtime.update"]
    root = roots[0]
    kids = [s for s in spans if s.parent == root.id]
    assert [s.name for s in kids] == RUNTIME_STAGES
    by = {s.name: s for s in kids}
    solves = [s for s in spans if s.name == "hsddp.solve"]
    assert len(solves) == 1 and solves[0].parent == by["runtime.solve"].id
    assert rt.timing == dict(
        build_ms=(by["runtime.upload"].end_ns - root.start_ns) / 1e6,
        solve_ms=by["runtime.solve"].host_ms,
        fetch_ms=by["runtime.fetch"].host_ms)
    assert rt.last_solve_ms == (by["runtime.fetch"].end_ns
                                - by["runtime.solve"].start_ns) / 1e6
    assert tracer.counts()[root.id]["hsddp.sync"] > 0


@pytest.fixture(scope="module")
def wb_model(tmp_path_factory):
    urdf = synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))
    return wb_lane.load_lane_model(urdf, "cpu", torch.float64)


@pytest.mark.parametrize("which", ["contact", "impulse"])
def test_wb_partials_spans(tracer, wb_model, which):
    """Each WB partial function is one span with the four stages under it
    in order, and counts its knots in `wb.cf_knots`."""
    rng = np.random.default_rng(3)
    q = torch.zeros(3, 18, dtype=torch.float64)
    q[:, 2] = 0.25
    q[:, 6:] = torch.tensor([0.0, -0.8, 1.6] * 4, dtype=torch.float64)
    q = q + 0.05 * torch.as_tensor(rng.normal(size=(3, 18)))
    v = torch.as_tensor(rng.normal(size=(3, 18)))
    tau = torch.as_tensor(rng.normal(size=(3, 18)))
    c = torch.tensor([[1.0, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0]],
                     dtype=torch.float64)
    tracer.enable()
    if which == "contact":
        wb_lane.contact_kkt_dynamics_partials_lane(wb_model, q, v, tau, c,
                                                   10.0)
    else:
        wb_lane.impulse_dynamics_partials_lane(wb_model, q, v, c)
    tracer.disable()
    spans = tracer.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [
        "wb.partials" if which == "contact" else "wb.impulse_partials"]
    r = roots[0]
    assert [s.name for s in spans if s.parent == r.id] == WB_STAGES
    assert len(_under(spans, r.id)) == len(WB_STAGES)
    assert tracer.counts()[r.id] == {"wb.cf_knots": 3}


# the spans of a barrel-roll solve
BR_SPANS = ("wb.partials", "wb.impulse_partials", "wb.step", "br.td_con")
# the knots a forward trial steps a scenario: every plan step, and the
# reset sites gathered to max_resets
BR_STEP_KNOTS = 130 + 16


@pytest.fixture(scope="module")
def br_traced(tmp_path_factory, one_torch_thread):
    """A B=2 f64 barrel-roll solve (pushed body velocities, 1 AL x 1 DDP)
    with the tracer off, then on; the inputs of the forward-mode Jacobians
    and of the closed-form bundles recorded by wrappers of
    `rbda.batched_jacobian` and `wb_lane.cf_bundle`, and the traced
    solve's forward trials by a wrapper of the problem's `dyn`."""
    _fresh()
    tmp = tmp_path_factory.mktemp("br")
    model = wbm.load_model(synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp)), "cpu", torch.float64)
    plan_np, pen_np, Xbar0, Ubar0, _ = br.build_barrel_roll_plan(
        write_synthetic_br_settings(str(tmp / "settings")))
    x0 = np.tile(br.initial_state(), (B, 1))
    x0[:, 18:21] += np.random.default_rng(5).normal(0.0, 0.2, (B, 3))
    plan, pen, Xbar0, Ubar0 = from_numpy((plan_np, pen_np, Xbar0, Ubar0),
                                         "cpu", torch.float64)
    args = (plan, broadcast_batch(pen, B), torch.as_tensor(x0),
            broadcast_batch(Xbar0, B), broadcast_batch(Ubar0, B))
    trials = []
    fns = br.make_barrel_roll_fns(model)
    dyn = fns.dyn
    fns = fns._replace(dyn=lambda X, U, sd: trials.append(X.shape[:-1])
                       or dyn(X, U, sd))
    solve = hsddp.make_solver(fns,
                              SolverOptions(max_AL_iter=1, max_DDP_iter=1),
                              fused_riccati=True, parallel_line_search=False,
                              max_resets=16)
    off = solve(*args)
    trials.clear()
    out = dict(off=off, off_spans=tracing.spans(),
               off_counts=tracing.counts())
    shapes, bundles = [], []
    jac, bundle = rbda.batched_jacobian, wb_lane.cf_bundle
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(rbda, "batched_jacobian",
                      lambda f, x: shapes.append(tuple(x.shape)) or jac(f, x))
        patch.setattr(wb_lane, "cf_bundle",
                      lambda m, q: bundles.append(tuple(q.shape))
                      or bundle(m, q))
        tracing.enable()
        try:
            on = solve(*args)
        finally:
            tracing.disable()
    out.update(on=on, shapes=shapes, bundles=bundles, trials=trials,
               spans=tracing.spans(), counts=tracing.counts())
    _fresh()
    return out


def _br_off(t):
    assert t["off_spans"] == [] and t["off_counts"] == {}


def _br_spans(t):
    spans = t["spans"]
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["hsddp.solve"]
    inside = _under(spans, roots[0].id)
    names = [s.name for s in inside]
    for name in BR_SPANS:
        assert name in names, name
    # the partials are taken inside the LQ stage, the forward step inside
    # the rollouts
    stages = {"wb.partials": ("hsddp.lq",),
              "wb.impulse_partials": ("hsddp.lq",),
              "wb.step": ("hsddp.rollout", "hsddp.line_search")}
    for s in inside:
        if s.name in stages:
            assert any(q.start_ns <= s.start_ns <= s.end_ns <= q.end_ns
                       for q in inside if q.name in stages[s.name]), s.name
    assert all(s.device_ms is None for s in inside)


def _br_directions(t):
    root = next(s.id for s in t["spans"] if s.parent is None)
    names = [s.name for s in t["spans"]]
    counts = t["counts"][root]
    # one bundle a linearization, over every knot it takes; no forward-mode
    # Jacobian
    assert t["shapes"] == []
    assert len(t["bundles"]) == names.count("wb.partials") \
        + names.count("wb.impulse_partials") > 0
    want = sum(math.prod(sh[:-1]) for sh in t["bundles"])
    assert counts["wb.cf_knots"] == want
    # the dynamics' linearization runs over every step of every scenario
    assert (B, 130, 18) in t["bundles"]


def _br_steps(t):
    root = next(s.id for s in t["spans"] if s.parent is None)
    names = [s.name for s in t["spans"]]
    # each forward trial steps every plan step and every gathered reset
    # site of every scenario: one `dyn` and one `reset`, each a `wb.step`
    assert t["trials"] and all(sh == (B, 130) for sh in t["trials"])
    assert names.count("wb.step") == 2 * len(t["trials"])
    assert t["counts"][root]["wb.step_knots"] \
        == len(t["trials"]) * BR_STEP_KNOTS * B


def _br_identical(t):
    for f in ("cost", "Xbar", "Ubar", "K", "success"):
        assert torch.equal(getattr(t["on"], f), getattr(t["off"], f)), f
    for a, b in zip(t["on"].info, t["off"].info):
        assert torch.equal(a, b)


BR_CASES = dict(off=_br_off, spans=_br_spans, directions=_br_directions,
                steps=_br_steps, identical=_br_identical)


@pytest.mark.parametrize("case", sorted(BR_CASES))
def test_traced_barrel_roll(br_traced, case):
    """Off: nothing recorded.  On: the closed-form WB partials', the lane
    forward step's and the touchdown constraint's spans under the solve's
    root, the partials inside the LQ stage and the step inside the
    rollouts; `wb.cf_knots` is the knots of every bundle taken (B x 130
    for the dynamics'), and no forward-mode Jacobian is taken;
    `wb.step_knots` is (130 + 16) x B a forward trial; the same answers
    bit for bit."""
    BR_CASES[case](br_traced)



# a small cascade with the SRB tail at dt 0.02 (the `cascade500` cell's):
# 40 WB steps and 5 resets, then 40 SRB steps
CASCADE = dict(plan_dur_wb=0.4, plan_dur_srb=0.8, dt_srb=0.02,
               wb_block=45, n_steps_max=85)
SRB_STEPS = 40
SRB_SPANS = {"srb.partials": ("hsddp.lq",),
             "srb.step": ("hsddp.rollout", "hsddp.line_search")}


@pytest.fixture(scope="module")
def cascade_traced(tmp_path_factory, one_torch_thread):
    """A B=2 f64 segmented cascade solve (1 AL x 1 DDP) with the tracer
    off, then on; the SRB segment's `dyn` and `dyn_partials` calls of the
    traced solve recorded by wrappers."""
    _fresh()
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(CASCADE["plan_dur_wb"] + CASCADE["plan_dur_srb"])
    cfg = mp.MHPCConfig(**CASCADE)
    plan_np, pen_np, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, cfg)
    model = wbm.load_model(synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot"))), "cpu", torch.float64)
    x0 = wb_state_ref_at(qr, 0.0)[None] \
        + 0.01 * np.random.default_rng(11).normal(size=(B, mp.XS))
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), "cpu", torch.float64)
    args = (plan, broadcast_batch(pen, B), x0, broadcast_batch(Xbar0, B),
            broadcast_batch(Ubar0, B))
    fns = mp.make_mhpc_fns_segmented(cfg, model)
    srb = fns.fns[1]
    calls = {"srb.step": [], "srb.partials": []}

    def rec(name, f):
        return lambda X, U, sd: calls[name].append(X.shape[:-1]) \
            or f(X, U, sd)
    fns = fns._replace(fns=(fns.fns[0], srb._replace(
        dyn=rec("srb.step", srb.dyn),
        dyn_partials=rec("srb.partials", srb.dyn_partials))))
    solve = hsddp.make_solver(fns,
                              SolverOptions(max_AL_iter=1, max_DDP_iter=1),
                              fused_riccati=True, parallel_line_search=False,
                              max_resets=16, reg_floor=1e-3)
    off = solve(*args)
    out = dict(off=off, off_spans=tracing.spans(),
               off_counts=tracing.counts())
    for v in calls.values():
        v.clear()
    tracing.enable()
    try:
        on = solve(*args)
    finally:
        tracing.disable()
    out.update(on=on, calls=calls, spans=tracing.spans(),
               counts=tracing.counts())
    _fresh()
    return out


def _srb_off(t):
    assert t["off_spans"] == [] and t["off_counts"] == {}


def _srb_spans(t):
    spans = t["spans"]
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["hsddp.solve"]
    inside = _under(spans, roots[0].id)
    names = [s.name for s in inside]
    for name, stages in SRB_SPANS.items():
        assert names.count(name) == len(t["calls"][name]) > 0, name
        for s in inside:
            if s.name == name:
                assert any(q.start_ns <= s.start_ns <= s.end_ns <= q.end_ns
                           for q in inside if q.name in stages), name
    assert all(s.device_ms is None for s in inside
               if s.name in SRB_SPANS)


def _srb_knots(t):
    root = next(s.id for s in t["spans"] if s.parent is None)
    counts = t["counts"][root]
    for name, counter in (("srb.step", "srb.step_knots"),
                          ("srb.partials", "srb.lin_knots")):
        calls = t["calls"][name]
        assert all(sh == (B, SRB_STEPS) for sh in calls), name
        assert counts[counter] == len(calls) * SRB_STEPS * B, counter


def _srb_identical(t):
    for f in ("cost", "Xbar", "Ubar", "K", "success"):
        assert torch.equal(getattr(t["on"], f), getattr(t["off"], f)), f
    for a, b in zip(t["on"].info, t["off"].info):
        assert torch.equal(a, b)


SRB_CASES = dict(off=_srb_off, spans=_srb_spans, knots=_srb_knots,
                 identical=_srb_identical)


@pytest.mark.parametrize("case", sorted(SRB_CASES))
def test_traced_cascade_srb_tail(cascade_traced, case):
    """Off: nothing recorded.  On: one `srb.partials` span a call of the
    SRB tail's linearization, inside the LQ stage, and one `srb.step`
    span a call of its forward step, inside the rollouts, all under the
    solve's root; `srb.lin_knots` and `srb.step_knots` are the SRB steps
    x B of each call, summed; the same answers bit for bit."""
    SRB_CASES[case](cascade_traced)

# ---- on the card --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_events_resolve_on_card(cuda, tracer):
    """On the card every span of a device stage resolves to positive,
    finite stream ms; host-only spans carry none."""
    solve, args = _solver(), _solve_args(cuda)
    solve(*args)
    tracer.enable()
    solve(*args)
    tracer.disable()
    spans = tracer.spans()
    dev = [s for s in spans if s.name in DEVICE_STAGES]
    assert DEVICE_STAGES == {s.name for s in dev}
    assert all(math.isfinite(s.device_ms) and s.device_ms > 0 for s in dev)
    assert all(s.device_ms is None for s in spans
               if s.name not in DEVICE_STAGES)


@pytest.mark.gpu
def test_spans_are_profiler_ranges_on_card(cuda, tracer):
    """Under a profile with CPU and CUDA activity each stage span is a
    `record_function` range of its name that holds the device time of the
    kernels launched inside it; with the tracer off there is none."""
    from torch.profiler import ProfilerActivity, profile
    solve, args = _solver(), _solve_args(cuda)
    solve(*args)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as off:
        solve(*args)
        torch.cuda.synchronize()
    tracer.enable()
    with profile(activities=acts) as on:
        solve(*args)
        torch.cuda.synchronize()
    tracer.disable()

    def device_us(prof):
        out = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            out[e.key] = e.cuda_time_total if t is None else t
        return out

    got, base = device_us(on), device_us(off)
    assert not ({"hsddp.solve"} | STAGES) & set(base)
    for name in ("hsddp.solve", "hsddp.lq", "hsddp.sweep", "hsddp.linroll",
                 "hsddp.line_search", "hsddp.select"):
        assert got.get(name, 0) > 0, name

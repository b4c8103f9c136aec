"""The port's `serve` loops against the JAX package's, f64 on CPU, over an
in-memory transport (what one endpoint publishes, every endpoint on the
bus handles, the publisher too, as multicast loopback does).

HKD: the port's and the JAX runtime's `serve` at test_torch_runtime.py's
plan (0.3 s, 40 steps, `SolverOptions()`) on the synthetic bound
reference, `debug_intermtraj` on, each fed the same three `hkd_data_lcmt`
states (a reset at 0, updates at 0.02 and 0.04).  The decoded
`hkd_command_lcmt`s agree to test_torch_runtime.py's 5e-5 as the port
runs (the sweep kernel's pivot rule against the JAX scan's exact
Cholesky; the feedback gains, which that test does not hold, to 5e-5 of
their largest magnitude) after the schema's f32 cast; mpc_times,
contacts and status times exactly.  The solver's
`iter_callback` sees the (Xbar, Ubar, it) sequence the JAX `io_callback`
sees, and the `intermediate_ddp_traj` messages count the AL iterations.

MHPC: the port's `MHPCRuntime.serve` at test_torch_mhpc_runtime.py's plan
against the JAX `MHPCRuntime.serve` whose solves are the port's solver on
the JAX-built plan (compiling the JAX segmented solver twice takes
minutes, and the JAX runtime loads the absent default URDF; the solves
themselves are held to the JAX package in test_torch_mhpc_solve.py): every
decoded `MHPC_Command_lcmt`, `solver_info_lcmt` (but its solve time) and
`solver_intermtraj_lcmt` is equal.

Port-only: an `mpctime` two periods on steps the reference window 40 ms;
three queued states give one solve, of the newest; `reset_mpc`
re-initializes.  After such a jump the JAX runtimes warm-start from the
previous solution as if one period had passed (`_warm_start` subtracts
`dt_mpc`, not the elapsed time, from the clock); the port aligns it by the
elapsed time, so the two are compared on steps of one period.
"""
import types

import numpy as np
import pytest
import torch

from cafempc_tpu.comms.udpm import LCMEndpoint as JaxEndpoint
from cafempc_tpu.problems import hkd_problem as jhp
from cafempc_tpu.problems import mhpc_problem as jmp
from cafempc_tpu.reference.quad_reference import \
    QuadReference as JaxQuadReference
from cafempc_tpu.runtime import mhpc_runtime as jmr
from cafempc_tpu.runtime.mpc import HKDMPCRuntime as JaxHKDRuntime
from cafempc_tpu.solver.options import SolverOptions as JaxSolverOptions
from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.comms.udpm import LCMEndpoint
from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference, synthetic_bound_reference_urdf)
from cafempc_tpu_torch.runtime.mhpc_runtime import MHPCRuntime
from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
from cafempc_tpu_torch.runtime.staged import solver_info_message
from cafempc_tpu_torch.solver import plan as pl
from cafempc_tpu_torch.solver.hsddp import make_solver
from cafempc_tpu_torch.solver.options import SolverOptions

HKD_PLAN = dict(plan_duration=0.3, n_steps_max=40)
MHPC_PLAN = dict(plan_dur_wb=0.1, plan_dur_srb=0.2, n_steps_max=24,
                 wb_block=16)
MHPC_OPTS = dict(max_AL_iter=2, max_DDP_iter=2, max_AL_iter_runtime=1,
                 max_DDP_iter_runtime=1)
TOL = 5e-5
# (reset_mpc, mpctime) of the states served
STATES = [(True, 0.0), (False, 0.02), (False, 0.04)]


class Bus:
    def __init__(self):
        self.members = []


class MemTransport:
    """The four-method transport on a Bus."""

    def __init__(self, bus):
        self.bus, self.queue, self.handlers = bus, [], {}
        bus.members.append(self)

    def publish(self, channel, data):
        for m in self.bus.members:
            m.queue.append((channel, bytes(data)))

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


class Client:
    """A port endpoint on the bus keeping every message it handles."""

    def __init__(self, bus):
        self.ep = LCMEndpoint(MemTransport(bus))
        self.got = {}
        for channel, cls in (("mpc_command", w.hkd_command_lcmt),
                             ("MHPC_COMMAND", w.MHPC_Command_lcmt),
                             ("DDP_Solver_Info", w.solver_info_lcmt),
                             ("intermediate_ddp_traj",
                              w.solver_intermtraj_lcmt)):
            self.ep.subscribe(channel, cls, lambda c, m: self.got.setdefault(
                c, []).append(m))

    def pump(self):
        while self.ep.handle():
            pass
        return self.got


def _hkd_state(k, reset, mpctime):
    body = np.zeros(12)
    body[5] = 0.2486 + 0.002 * k
    body[9] = 0.05 * k
    return w.hkd_data_lcmt(
        reset_mpc=reset, MS=True, mpctime=mpctime,
        contact=np.ones(4, np.int32), rpy=body[0:3][::-1], p=body[3:6],
        omegaBody=body[6:9], vWorld=body[9:12], qJ=[0.0, -0.8, 1.6] * 4,
        foot_placements=np.zeros(12))


def _hkd_qr(cls):
    qr = cls(synthetic_bound_reference(duration=1.0))
    qr.initialize(HKD_PLAN["plan_duration"])
    return qr


class PortHKD(HKDMPCRuntime):
    def _intermtraj_callback(self, Xbar, Ubar, it):
        self.seen.append((to_numpy(Xbar[0]), to_numpy(Ubar[0]), it))
        super()._intermtraj_callback(Xbar, Ubar, it)


class JaxHKD(JaxHKDRuntime):
    def _intermtraj_callback(self, Xbar, Ubar, it):
        self.seen.append((np.asarray(Xbar), np.asarray(Ubar), int(it)))
        super()._intermtraj_callback(Xbar, Ubar, it)


def _serve(rt, ep, client, states):
    """Serve each state in turn; per solve what the client received, the
    callbacks seen, the reference window's start and the port's result."""
    steps = []
    for msg in states:
        client.ep.publish(msg[0], msg[1])
        n_seen = len(getattr(rt, "seen", []))
        assert rt.serve(ep, max_msgs=1) == 1
        steps.append(dict(
            seen=getattr(rt, "seen", [])[n_seen:], mpc_time=rt.mpc_time,
            t_ref=rt.qr.get_start_time(),
            result=getattr(rt, "result", None),
            info=(solver_info_message(rt.result, rt.last_solve_ms)
                  if isinstance(rt, (HKDMPCRuntime, MHPCRuntime)) else None)))
    return steps, client.pump()


@pytest.fixture(scope="module")
def hkd_served():
    out = {}
    states = [("mpc_data", _hkd_state(k, *s)) for k, s in enumerate(STATES)]
    for pkg in ("jax", "port"):
        bus = Bus()
        if pkg == "jax":
            ep = JaxEndpoint(MemTransport(bus))
            rt = JaxHKD(_hkd_qr(JaxQuadReference), jhp.HKDConfig(**HKD_PLAN),
                        JaxSolverOptions(), endpoint=ep,
                        debug_intermtraj=True)
        else:
            ep = LCMEndpoint(MemTransport(bus))
            rt = PortHKD(_hkd_qr(QuadReference), hp.HKDConfig(**HKD_PLAN),
                         SolverOptions(), device="cpu", endpoint=ep,
                         debug_intermtraj=True)
        rt.seen = []
        out[pkg] = _serve(rt, ep, Client(bus), states)
    return out


def test_hkd_served_commands_match_jax(hkd_served):
    (_, jgot), (_, got) = hkd_served["jax"], hkd_served["port"]
    assert len(got["mpc_command"]) == len(jgot["mpc_command"]) == 3
    for g, j in zip(got["mpc_command"], jgot["mpc_command"]):
        assert g.N_mpcsteps == j.N_mpcsteps == 10
        for f in ("mpc_times", "contacts", "statusTimes"):
            np.testing.assert_array_equal(getattr(g, f), getattr(j, f), f)
        for f in ("hkd_controls", "des_body_state", "foot_placement"):
            np.testing.assert_allclose(getattr(g, f), getattr(j, f),
                                       rtol=0, atol=TOL, err_msg=f)
        np.testing.assert_allclose(
            g.feedback, j.feedback, rtol=0,
            atol=TOL * np.abs(j.feedback).max())
    assert [c.mpc_times[0] for c in got["mpc_command"]] == [0.0, 0.02, 0.04]


def test_iter_callback_matches_jax_io_callback(hkd_served):
    """Per solve, the same number of AL iterations with the same `it`, and
    the nominal trajectory after each within the tape's tolerance."""
    (jsteps, _), (steps, _) = hkd_served["jax"], hkd_served["port"]
    for s, j in zip(steps, jsteps):
        assert [it for _, _, it in s["seen"]] == \
            [it for _, _, it in j["seen"]] == list(range(len(j["seen"])))
        assert len(s["seen"]) >= 1
        for (X, U, _), (jX, jU, _) in zip(s["seen"], j["seen"]):
            np.testing.assert_allclose(X, jX, rtol=0, atol=TOL)
            np.testing.assert_allclose(U, jU, rtol=0, atol=TOL)


def test_intermtraj_messages_count_the_al_iterations(hkd_served):
    """One solver_intermtraj_lcmt per AL outer iteration, as the JAX
    package publishes; the updates run 1 DDP iteration per AL iteration,
    so their count is also the solver's iters."""
    (jsteps, jgot), (steps, got) = hkd_served["jax"], hkd_served["port"]
    n_al = [len(s["seen"]) for s in steps]
    assert n_al == [len(s["seen"]) for s in jsteps]
    assert len(got["intermediate_ddp_traj"]) == sum(n_al) \
        == len(jgot["intermediate_ddp_traj"])
    for s in steps[1:]:
        assert len(s["seen"]) == int(s["result"].info.iters)
    for m, (X, U, _) in zip(got["intermediate_ddp_traj"],
                            [x for s in steps for x in s["seen"]]):
        assert (m.tau_sz, m.x_sz, m.u_sz) == (41, 24, 24)
        np.testing.assert_array_equal(m.x_tau, X.astype(np.float32))
        np.testing.assert_array_equal(m.u_tau[:-1], U.astype(np.float32))


def test_solver_info_equals_the_result(hkd_served):
    (jsteps, jgot), (steps, got) = hkd_served["jax"], hkd_served["port"]
    assert len(got["DDP_Solver_Info"]) == 3
    for m, jm, s in zip(got["DDP_Solver_Info"], jgot["DDP_Solver_Info"],
                        steps):
        r = s["result"]
        assert (m.n_iter, m.n_ls_iter, m.n_reg_iter) == (
            int(r.info.iters), int(r.info.ls_iters), int(r.info.reg_iters))
        assert m.cost == np.float32(r.cost)
        assert m.dyn_feas == np.float32(r.feas)
        assert m.ineq_violation == np.float32(r.max_pconstr)
        assert m.eq_violation == np.float32(r.max_tconstr)
        assert m.solve_time > 0.0
        assert m.n_iter == jm.n_iter
        np.testing.assert_allclose(m.cost, jm.cost, rtol=1e-6)


def test_clock_follows_mpctime_in_both_packages(hkd_served):
    for pkg in ("jax", "port"):
        steps, _ = hkd_served[pkg]
        assert [s["mpc_time"] for s in steps] == [0.0, 0.02, 0.04]
        np.testing.assert_allclose([s["t_ref"] for s in steps],
                                   [0.0, 0.02, 0.04], rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def port_queue():
    """A port runtime initialized at t=0; served a state at 0.04 (two
    periods on); then 3 states (0.06, 0.08, 0.10) queued before one
    serve(max_msgs=1); then a reset state at 0.12."""
    bus = Bus()
    ep = LCMEndpoint(MemTransport(bus))
    client = Client(bus)
    rt = HKDMPCRuntime(_hkd_qr(QuadReference), hp.HKDConfig(**HKD_PLAN),
                       SolverOptions(), device="cpu")
    inits, solves = [], []
    real_init, real_solve = rt.initialize, rt._solve
    rt.initialize = lambda x: inits.append(rt.mpc_time) or real_init(x)
    rt._solve = lambda *a: solves.append(1) or real_solve(*a)
    clock = []
    for k, t in ((0, 0.0), (1, 0.04)):
        client.ep.publish("mpc_data", _hkd_state(k, k == 0, t))
        rt.serve(ep, max_msgs=1)
        clock.append((rt.mpc_time, rt.qr.get_start_time()))
    n0 = len(solves)
    for k in (3, 4, 5):
        client.ep.publish("mpc_data", _hkd_state(k, False, 0.02 * k))
    served = rt.serve(ep, max_msgs=1)
    queued = dict(served=served, solves=len(solves) - n0,
                  mpc_time=rt.mpc_time, iters=int(rt.result.info.iters))
    client.ep.publish("mpc_data", _hkd_state(6, True, 0.12))
    rt.serve(ep, max_msgs=1)
    return dict(clock=clock, queued=queued, inits=inits, rt=rt,
                got=client.pump())


def test_mpctime_jump_steps_the_reference(port_queue):
    """A state two periods after the last moves the MPC clock and the
    reference window by 40 ms."""
    (t0, ref0), (t1, ref1) = port_queue["clock"]
    assert (t0, t1) == (0.0, 0.04)
    assert abs((ref1 - ref0) - 0.04) < 1e-12


def test_queued_states_give_one_solve_of_the_newest(port_queue):
    queued = port_queue["queued"]
    assert queued["served"] == 1 and queued["solves"] == 1
    assert abs(queued["mpc_time"] - 0.10) < 1e-12
    np.testing.assert_allclose(
        [c.mpc_times[0] for c in port_queue["got"]["mpc_command"]],
        [0.0, 0.04, 0.10, 0.12], rtol=0, atol=1e-12)


def test_reset_mpc_reinitializes(port_queue):
    rt = port_queue["rt"]
    assert port_queue["inits"] == [0.0, 0.12]
    assert rt.mpc_time == 0.12
    # the init solve runs the full caps (2 AL x 3 DDP), an update 2 x 1
    assert port_queue["queued"]["iters"] <= 2 < int(rt.result.info.iters)


# ---------------- MHPC ---------------------------------------------------

@pytest.fixture(scope="module")
def robot(tmp_path_factory):
    return wbm.load_model(synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot"))), "cpu", torch.float64)


def _mhpc_qr(cls):
    qr = cls(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(0.4)
    return qr


def _mhpc_states():
    x = wb_state_ref_at(_mhpc_qr(QuadReference), 0.0)
    out = []
    for k, (reset, t) in enumerate(STATES):
        xk = x + 0.002 * k
        out.append(("MHPC_DATA", w.MHPC_Data_lcmt(
            reset_mpc=reset, MS=True, mpctime=t, pos=xk[0:3], eul=xk[3:6],
            qJ=xk[6:18], vWorld=xk[18:21], eulrate=xk[21:24],
            qJd=xk[24:36])))
    return out


def _jax_mhpc_runtime(robot):
    """The JAX MHPCRuntime with its solves run by the port's solver on the
    plan, penalties and guess the JAX runtime built (converted by field
    name), its intermediate trajectories published by the JAX callback."""
    j = object.__new__(jmr.MHPCRuntime)
    j.endpoint, j.qr, j.cfg = None, _mhpc_qr(JaxQuadReference), \
        jmp.MHPCConfig(**MHPC_PLAN)
    j.dtype, j.n_cmd_steps, j.foot_handoff, j.model = None, 8, False, None
    j.mpc_time, j.state, j.plan_np, j.meta = 0.0, None, None, None
    j.last_solve_ms = j.avg_solve_ms = j.max_solve_ms = 0.0
    j._n_solves = 0
    fns = mp.make_mhpc_fns_segmented(mp.MHPCConfig(**MHPC_PLAN), robot)

    def callback(X, U, it):
        j._intermtraj_callback(to_numpy(X[0]), to_numpy(U[0]), it)

    def adapt(solve):
        def run(plan, pen, x0, Xbar0, Ubar0):
            def t(a):
                return from_numpy(np.asarray(a), "cpu", torch.float64)
            s = solve(pl.KnotPlan(
                pl.StepData(*[t(a) for a in plan.step]),
                pl.KnotData(*[t(a) for a in plan.knot])),
                pl.PenaltyParams(*[t(a)[None] for a in pen]),
                t(x0)[None], t(Xbar0)[None], t(Ubar0)[None])
            first = types.SimpleNamespace
            return first(
                traj=first(**{k: to_numpy(getattr(s.traj, k)[0]) for k in (
                    "Xbar", "Ubar", "Y", "K", "Qu", "Quu", "Qux")}),
                info=first(**{k: to_numpy(getattr(s.info, k)[0]) for k in (
                    "iters", "ls_iters", "reg_iters")}),
                **{k: to_numpy(getattr(s, k)[0]) for k in (
                    "cost", "feas", "max_pconstr", "max_tconstr")})
        return run

    opts = SolverOptions(**MHPC_OPTS)
    kw = dict(fused_riccati=True, parallel_line_search=False, max_resets=8,
              trim_output=False, iter_callback=callback)
    j.solve_init = adapt(make_solver(fns, opts, **kw))
    j.solve_rt = adapt(make_solver(fns, opts.runtime(), **kw))
    return j


@pytest.fixture(scope="module")
def mhpc_served(robot):
    out = {}
    for pkg in ("jax", "port"):
        bus = Bus()
        if pkg == "jax":
            ep, rt = JaxEndpoint(MemTransport(bus)), _jax_mhpc_runtime(robot)
        else:
            ep = LCMEndpoint(MemTransport(bus))
            rt = MHPCRuntime(_mhpc_qr(QuadReference),
                             mp.MHPCConfig(**MHPC_PLAN),
                             SolverOptions(**MHPC_OPTS), model=robot,
                             device="cpu", debug_intermtraj=True)
        out[pkg] = _serve(rt, ep, Client(bus), _mhpc_states())
    return out


def test_mhpc_served_commands_match_jax(mhpc_served):
    (_, jgot), (_, got) = mhpc_served["jax"], mhpc_served["port"]
    assert len(got["MHPC_COMMAND"]) == len(jgot["MHPC_COMMAND"]) == 3
    for g, j in zip(got["MHPC_COMMAND"], jgot["MHPC_COMMAND"]):
        assert g.N_mpcsteps == 8 and g.encode() == j.encode()
    np.testing.assert_allclose(
        [c.mpc_times[0] for c in got["MHPC_COMMAND"]], [0.0, 0.02, 0.04],
        rtol=0, atol=1e-7)


def test_mhpc_telemetry_matches_jax(mhpc_served):
    """The serving endpoint was adopted for the telemetry: one
    solver_info_lcmt per solve equal to the runtime's result (the solve
    time aside) and the JAX runtime's, one intermediate trajectory per AL
    iteration, byte-equal to the JAX runtime's."""
    (jsteps, jgot), (steps, got) = mhpc_served["jax"], mhpc_served["port"]
    assert len(got["DDP_Solver_Info"]) == len(jgot["DDP_Solver_Info"]) == 3
    for m, jm, s in zip(got["DDP_Solver_Info"], jgot["DDP_Solver_Info"],
                        steps):
        want = w.f32_cast(s["info"])
        for f in ("n_iter", "n_ls_iter", "n_reg_iter", "cost", "dyn_feas",
                  "ineq_violation", "eq_violation"):
            assert getattr(m, f) == getattr(want, f) == getattr(jm, f), f
    n = [len(m.encode()) for m in got["intermediate_ddp_traj"]]
    assert len(n) == len(jgot["intermediate_ddp_traj"])
    # init: 2 AL iterations at most; updates: 1 AL x 1 DDP
    assert 3 <= len(n) <= 4
    for m, jm in zip(got["intermediate_ddp_traj"],
                     jgot["intermediate_ddp_traj"]):
        assert m.encode() == jm.encode()
        assert (m.x_sz, m.u_sz) == (36, 12)

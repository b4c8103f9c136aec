"""MHPC cascaded-fidelity problem: whole-body front horizon + SRB tail
(port of `cafempc_tpu/problems/mhpc_problem.py` and of the WB-segment batch
functions of `cafempc_tpu/problems/mhpc_lane.py`).

Functional mirror of the reference MHPC application layer
(MHPC/MHPC-Trajopt/MHPCProblem.{h,cpp}, MHPCCost.*, MHPCConstraint.*,
MHPCReset.*, MHPCFootStep.h):

  * phase discovery over [0, plan_dur_wb] at dt_wb + one SRB tail phase
    at dt_srb (MHPCProblem.cpp:89-146);
  * the cascade on ONE 36-dim state: the 12-dim SRB state is embedded at
    the body dims (pos, eul -> 0:6; vel, eulrate -> 18:24) and the
    reference's 12 x 36 StateProjection (MHPCReset.h:20-26) is a diagonal
    body mask applied at the model-switch reset step;
  * WB costs: tracking, foot-place reg, swing pos/vel tracking, touchdown
    velocity penalty (MHPCCost.cpp); SRB tracking cost;
  * path constraints: torque limit, joint box, min height, GRF friction
    pyramid (on the GRF output y for WB, on u for SRB), joint speed (off by
    default) (MHPCConstraint.cpp);
  * reset: impact at touchdown, projection at model switch
    (MHPCReset.cpp:4-53).

The plan builder and the settings loaders are host-side numpy, copied
here because the JAX module imports jax at its top.  The problem functions
take the whole batch: states [B, n, 36] against plan slices [n, ...].
`make_mhpc_fns(cfg, model)` is the JAX package's default, the joint mode:
one set of functions over every step, each evaluating both models and
selecting on `model_id`.  `make_mhpc_fns_segmented` runs the WB functions
on the WB steps only and the SRB functions on the tail only.  In the WB
segment there is one implementation, the batched form of the JAX lane
overrides on `models/wb_lane.py` (the JAX package's per-knot WB functions
compute the same values); the JAX lane folding and lane chunking are TPU
mechanics and are not ported.  The WB dynamics and reset partials are the
factored-KKT assembly on the closed-form FK bundle (`models/wb_lane.py`);
the JAX package's forward-mode AD and jvp-direction routes compute the
same partials and are the tests' references.
"""
import dataclasses
import json
import math
import re
import types

import numpy as np
import torch

from cafempc_tpu_torch.models import rbda, srb, wb_lane, wbm
from cafempc_tpu_torch.reference.quad_reference import (
    QuadReference, srb_state_ref_at, wb_state_ref_at)
from cafempc_tpu_torch.solver.hsddp import ProblemFns, SegmentedFns
from cafempc_tpu_torch.solver.plan import (KnotData, KnotPlan,
                                           PenaltyParams, StepData)
from cafempc_tpu_torch.utils import tracing

XS, US, YS = 36, 12, 12
NQ = 18
# path-constraint layout:
# [torque(24) | joint(24) | minheight(1) | grf(20) | jointspeed(24)]
N_PCON = 93
N_TCON = 4
TORQUE_LIMIT = 17.0                  # MHPCConstraint.cpp:77
JOINT_SPEED_LIMIT = 20.0             # MHPCConstraint.h:72-73 (+-20 rad/s)
JOINT_LB = np.array([-1.3, -5.0, -np.pi])   # MHPCConstraint.cpp:172
JOINT_UB = np.array([1.3, 5.0, np.pi])
MIN_HEIGHT_WB = 0.20                 # MHPCConstraint.h (WBMinimumHeight)
MIN_HEIGHT_SRB = 0.18                # MHPCConstraint.h (SRBMMinimumHeight)
MU_WB = 0.6                          # MHPCConstraint.cpp:11

# embedding masks: SRB dims within the 36-dim WB layout
BODY_DIMS = np.r_[0:6, 18:24]
BODY_MASK36 = np.zeros(36)
BODY_MASK36[BODY_DIMS] = 1.0


@dataclasses.dataclass
class MHPCConfig:
    """(MHPC/settings/mhpc_config.info, MHPCProblem.h:24-83)."""
    plan_dur_wb: float = 0.25
    plan_dur_srb: float = 0.50
    dt_mpc: float = 0.02
    dt_wb: float = 0.01
    dt_srb: float = 0.05
    BG_alpha: float = 10.0
    n_steps_max: int = 48
    # static step index where the SRB tail segment begins (carry-pad
    # layout, see build_mhpc_plan); must exceed the max WB content length
    # (25 dyn steps + intra-WB resets + 1 model-switch reset)
    wb_block: int = 32
    # cost weights (cost_weights_*.JSON); None -> constructor defaults
    wb_q: np.ndarray = None
    wb_r: np.ndarray = None
    wb_qf: np.ndarray = None
    srb_q: np.ndarray = None
    srb_r: np.ndarray = None
    srb_qf: np.ndarray = None
    qfoot_reg: np.ndarray = None
    qfoot_swing_pos: np.ndarray = None
    qfoot_swing_vel: np.ndarray = None
    # constraint params (constraint_params_*.info)
    reb: dict = None
    td_al_sigma: float = 10.0
    td_al_sigma_max: float = 1e4
    td_al_lambda: float = 0.0
    # JointSpeedLimit (MHPCConstraint.cpp:118-160): compiled but disabled
    # by default in the reference -> flag-gated off here too
    joint_speed_limit: bool = False
    # which path constraints are armed: "regular" = torque + joint box +
    # min height + GRF (MHPCProblem.cpp:428-481); "loco" = torque + GRF
    # only (LocoProblem.cpp:66-89)
    pcon_set: str = "regular"
    # file names from the config .info (referenceFile/costFile/...)
    reference_file: str = ""
    cost_file: str = ""
    constraint_file: str = ""


def _default_weights(cfg: MHPCConfig):
    """Constructor defaults (MHPCCost.h:12-38, 226-249)."""
    if cfg.wb_q is None:
        cfg.wb_q = np.concatenate([
            [0.0, 0.0, 50.0], [2.0, 10.0, 5.0], np.ones(12),
            [2.0, 4.0, 4.0], [1.0, 2.0, 2.0], 0.01 * np.ones(12)])
    if cfg.wb_r is None:
        cfg.wb_r = 0.1 * np.ones(12)
    if cfg.wb_qf is None:
        qf = cfg.wb_q.copy()
        qf[6:18] = 0.5
        qf[24:36] = 0.01
        cfg.wb_qf = qf
    if cfg.srb_q is None:
        cfg.srb_q = np.concatenate([
            [0.0, 0.0, 50.0], [0.0, 10.0, 5.0], [2.0, 3.0, 3.0],
            [0.5, 0.5, 0.5]])
    if cfg.srb_r is None:
        cfg.srb_r = 0.01 * np.ones(12)
    if cfg.srb_qf is None:
        cfg.srb_qf = 0.5 * cfg.srb_q
    if cfg.qfoot_reg is None:
        cfg.qfoot_reg = np.array([10.0, 10.0, 1.0])
    if cfg.qfoot_swing_pos is None:
        cfg.qfoot_swing_pos = np.array([10.0, 10.0, 40.0])
    if cfg.qfoot_swing_vel is None:
        cfg.qfoot_swing_vel = np.array([2.0, 2.0, 4.0])
    if cfg.reb is None:
        cfg.reb = {
            "GRF": dict(delta=0.1, delta_min=0.1, eps=0.3),
            "Torque": dict(delta=0.1, delta_min=0.1, eps=0.1),
            "Joint": dict(delta=0.1, delta_min=0.1, eps=0.1),
            "MinHeight": dict(delta=0.01, delta_min=0.01, eps=0.1),
        }
    return cfg


def load_mhpc_config(fname) -> MHPCConfig:
    """The ``config { key value ... }`` block of mhpc_config.info."""
    with open(fname) as fh:
        body = re.search(r"config\s*\{(.*?)\}", fh.read(), re.S).group(1)
    kv = dict(ln.split()[:2] for ln in body.splitlines() if ln.split())
    cfg = MHPCConfig(
        plan_dur_wb=float(kv.get("plan_dur_wb", 0.25)),
        plan_dur_srb=float(kv.get("plan_dur_srb", 0.50)),
        dt_mpc=float(kv.get("dt_mpc", 0.02)),
        dt_wb=float(kv.get("dt_wb", 0.01)),
        dt_srb=float(kv.get("dt_srb", 0.05)),
        BG_alpha=float(kv.get("BG_alpha", 10.0)),
        reference_file=kv.get("referenceFile", ""),
        cost_file=kv.get("costFile", ""),
        constraint_file=kv.get("constraintParamFile", ""))
    return _default_weights(cfg)


def load_cost_weights(fname, cfg: MHPCConfig) -> MHPCConfig:
    """JSON loader (MHPCCostUtil.h:9-143 layout)."""
    with open(fname) as fh:
        d = json.load(fh)
    wb = d["WB_Tracking_Cost"]
    cfg.wb_q = np.concatenate([
        wb["qw_qB"], np.tile(wb["qw_qJ"], 4), wb["qw_vB"],
        np.tile(wb["qw_vJ"], 4)])
    cfg.wb_r = np.full(12, float(wb["rw"]))
    cfg.wb_qf = np.concatenate([
        wb["qfw_qB"], np.tile(wb["qfw_qJ"], 4), wb["qfw_vB"],
        np.tile(wb["qfw_vJ"], 4)])
    sb = d["SRB_Tracking_Cost"]
    cfg.srb_q = np.concatenate([sb["qw_qB"], sb["qw_vB"]])
    cfg.srb_r = np.full(12, float(sb["rw"]))
    cfg.srb_qf = np.concatenate([sb["qfw_qB"], sb["qfw_vB"]])
    cfg.qfoot_reg = np.asarray(d["WB_FootPlace_Reg"]["qw_per_foot"],
                               dtype=float)
    cfg.qfoot_swing_pos = np.asarray(
        d["Swing_Pos_Tracking"]["qw_per_foot"], dtype=float)
    cfg.qfoot_swing_vel = np.asarray(
        d["Swing_Vel_Tracking"]["qw_per_foot"], dtype=float)
    return cfg


def load_constraint_params(fname, cfg: MHPCConfig) -> MHPCConfig:
    """The ``<name>_ReB { ... }`` and ``TD_AL { ... }`` blocks of
    constraint_params_*.info; a block that is absent keeps cfg's values."""
    with open(fname) as fh:
        txt = fh.read()

    def block(name):
        m = re.search(name + r"_ReB\s*\{(.*?)\}", txt, re.S)
        out = {}
        if m:
            for ln in m.group(1).splitlines():
                p = ln.split()
                if len(p) == 2:
                    out[p[0]] = float(p[1])
        return out

    cfg.reb = {k: block(k) or cfg.reb[k]
               for k in ("GRF", "Torque", "Joint", "MinHeight")}
    m = re.search(r"TD_AL\s*\{(.*?)\}", txt, re.S)
    if m:
        kv = dict((ln.split()[0], float(ln.split()[1]))
                  for ln in m.group(1).splitlines() if len(ln.split()) == 2)
        cfg.td_al_sigma = kv.get("sigma", cfg.td_al_sigma)
        cfg.td_al_sigma_max = kv.get("sigma_max", cfg.td_al_sigma_max)
        cfg.td_al_lambda = kv.get("lambda", cfg.td_al_lambda)
    return cfg


# ------------------------------------------------------------------
# Plan construction (host-side numpy)
# ------------------------------------------------------------------

def embed_srb(x12):
    x = np.zeros(36)
    x[BODY_DIMS] = x12
    return x


def discover_wb_phases(quad_ref: QuadReference, plan_dur_wb, dt):
    """(MHPCProblem.cpp:106-137)."""
    phases = []
    t = 0.0
    c_prev = np.array(quad_ref.contact_at_t(0.0))
    start = 0.0
    eps = 1e-6
    while t <= plan_dur_wb + eps:
        c = np.array(quad_ref.contact_at_t(t))
        if (c != c_prev).any() or abs(t - plan_dur_wb) < eps:
            horizon = int(round((t - start) / dt))
            if horizon > 0:
                phases.append((start, t, horizon, c_prev.copy()))
            c_prev = c
            start = t
        t += dt
    return phases


def build_mhpc_plan(quad_ref: QuadReference, cfg: MHPCConfig):
    """Flat cascaded plan.  Returns (plan, pen, Xbar0, Ubar0, meta)."""
    cfg = _default_weights(cfg)
    N = cfg.n_steps_max
    wb_phases = discover_wb_phases(quad_ref, cfg.plan_dur_wb, cfg.dt_wb)
    n_wb = len(wb_phases)
    srb_horizon = int(round(cfg.plan_dur_srb / cfg.dt_srb))
    contact_after_wb = np.array(
        quad_ref.contact_at_t(cfg.plan_dur_wb + cfg.dt_mpc))

    step = dict(
        active=np.zeros(N), is_reset=np.zeros(N), dt=np.full(N, cfg.dt_wb),
        t=np.zeros(N), contact=np.zeros((N, 4)),
        contact_next=np.zeros((N, 4)), x_ref=np.zeros((N, XS)),
        u_ref=np.zeros((N, US)), y_ref=np.zeros((N, YS)),
        pf_ref=np.zeros((N, 12)), com_ref=np.zeros((N, 3)),
        vf_ref=np.zeros((N, 12)), ref_contact=np.zeros((N, 4)),
        model_id=np.zeros(N), model_switch=np.zeros(N),
        q_diag=np.zeros((N, 0)), r_diag=np.zeros((N, 0)))
    knot = dict(
        active=np.zeros(N + 1), is_terminal=np.zeros(N + 1),
        td_mask=np.zeros((N + 1, 4)), contact=np.zeros((N + 1, 4)),
        ref_contact=np.zeros((N + 1, 4)), model_id=np.zeros(N + 1),
        qf_diag=np.zeros((N + 1, 0)),
        x_ref=np.zeros((N + 1, XS)), pf_ref=np.zeros((N + 1, 12)),
        com_ref=np.zeros((N + 1, 3)), t=np.zeros(N + 1))
    Xbar0 = np.zeros((N + 1, XS))
    Ubar0 = np.zeros((N, US))

    def state_ref(t, model_id):
        return (wb_state_ref_at(quad_ref, t) if model_id == 0
                else embed_srb(srb_state_ref_at(quad_ref, t)))

    def fill_step(j, t, dt, contact, model_id):
        rec = quad_ref.record_at_t(t)
        step["t"][j] = t
        step["dt"][j] = dt
        step["contact"][j] = contact
        step["ref_contact"][j] = rec["contact"]
        step["model_id"][j] = model_id
        step["pf_ref"][j] = rec["foot_placements"]
        step["com_ref"][j] = rec["body_state"][0:3]
        step["vf_ref"][j] = rec["foot_velocities"]
        step["x_ref"][j] = state_ref(t, model_id)
        if model_id == 0:
            step["u_ref"][j] = rec["torque"]
            step["y_ref"][j] = rec["grf"]
        else:
            step["u_ref"][j] = rec["grf"]

    def fill_knot(j, t, contact, model_id):
        rec = quad_ref.record_at_t(t)
        knot["active"][j] = 1.0
        knot["t"][j] = t
        knot["contact"][j] = contact
        knot["ref_contact"][j] = rec["contact"]
        knot["model_id"][j] = model_id
        knot["pf_ref"][j] = rec["foot_placements"]
        knot["com_ref"][j] = rec["body_state"][0:3]
        knot["x_ref"][j] = state_ref(t, model_id)

    j = 0
    for ip, (ts, te, hor, contact) in enumerate(wb_phases):
        for k in range(hor):
            t = ts + k * cfg.dt_wb
            step["active"][j] = 1.0
            fill_step(j, t, cfg.dt_wb, contact, 0)
            fill_knot(j, t, contact, 0)
            Xbar0[j] = wb_state_ref_at(quad_ref, t)
            j += 1
        # phase-terminal knot
        fill_knot(j, te, contact, 0)
        knot["is_terminal"][j] = 1.0
        Xbar0[j] = wb_state_ref_at(quad_ref, te)
        contact_next = (wb_phases[ip + 1][3] if ip + 1 < n_wb
                        else contact_after_wb)
        knot["td_mask"][j] = ((contact == 0) & (contact_next == 1)) \
            .astype(float)
        # reset step (to the next WB phase, or into the SRB tail); the last
        # WB phase gets no reset when there is no SRB tail (plan_dur_srb = 0)
        is_last_wb = ip + 1 >= n_wb
        if is_last_wb and srb_horizon == 0:
            break
        if is_last_wb:
            # Static-layout padding: identity carry-pad reset steps up to
            # the segment boundary, so that the SRB tail always starts at
            # step wb_block (contact_next == contact -> identity reset; the
            # sweep's transform branch carries (G, H) through unchanged);
            # then the WB->SRB model-switch reset at wb_block-1.
            assert j <= cfg.wb_block - 1, \
                (f"WB content ({j} steps) exceeds wb_block-1 "
                 f"({cfg.wb_block - 1}); raise MHPCConfig.wb_block")
            while j < cfg.wb_block - 1:
                step["active"][j] = 1.0
                step["is_reset"][j] = 1.0
                fill_step(j, te, cfg.dt_wb, contact, 0)
                step["contact_next"][j] = contact
                j += 1
                fill_knot(j, te, contact, 0)
                Xbar0[j] = wb_state_ref_at(quad_ref, te)
            step["active"][j] = 1.0
            step["is_reset"][j] = 1.0
            fill_step(j, te, cfg.dt_wb, contact, 0)
            step["contact_next"][j] = contact_next
            step["model_switch"][j] = 1.0
            j += 1
        else:
            step["active"][j] = 1.0
            step["is_reset"][j] = 1.0
            fill_step(j, te, cfg.dt_wb, contact, 0)
            step["contact_next"][j] = contact_next
            j += 1

    # SRB tail phase
    if srb_horizon > 0:
        assert j == cfg.wb_block, (j, cfg.wb_block)
        srb_t0 = cfg.plan_dur_wb
        for k in range(srb_horizon):
            t = srb_t0 + k * cfg.dt_srb
            step["active"][j] = 1.0
            fill_step(j, t, cfg.dt_srb, np.zeros(4), 1)
            fill_knot(j, t, np.zeros(4), 1)
            Xbar0[j] = embed_srb(srb_state_ref_at(quad_ref, t))
            j += 1
        t_end = srb_t0 + srb_horizon * cfg.dt_srb
        fill_knot(j, t_end, np.zeros(4), 1)
        knot["is_terminal"][j] = 1.0
        Xbar0[j] = embed_srb(srb_state_ref_at(quad_ref, t_end))

    n_knots = j + 1
    assert n_knots <= N + 1, (n_knots, N)
    Xbar0[n_knots:] = Xbar0[n_knots - 1]
    plan = KnotPlan(StepData(**step), KnotData(**knot))

    # ---- penalty params -------------------------------------------
    reb_delta = np.ones((N, N_PCON))
    reb_eps = np.zeros((N, N_PCON))
    reb_active = np.zeros((N, N_PCON))
    reb_delta_min = np.ones(N_PCON)
    blocks = [("Torque", slice(0, 24)), ("Joint", slice(24, 48)),
              ("MinHeight", slice(48, 49)), ("GRF", slice(49, 69)),
              ("JointSpeed", slice(69, 93))]
    for name, sl in blocks:
        p = cfg.reb.get(name, dict(delta=0.1, delta_min=0.1, eps=0.1))
        reb_delta[:, sl] = p["delta"]
        reb_delta_min[sl] = p["delta_min"]
        reb_eps[:, sl] = p["eps"]
    for k in range(N):
        if not step["active"][k] or step["is_reset"][k]:
            continue
        if step["model_id"][k] == 0:
            if cfg.pcon_set == "loco":
                # LocoProblem arms only torque + GRF (LocoProblem.cpp:66-89)
                reb_active[k, 0:24] = 1.0
            else:
                reb_active[k, 0:49] = 1.0
            if cfg.joint_speed_limit:
                reb_active[k, 69:93] = 1.0
            for leg in range(4):
                reb_active[k, 49 + 5 * leg:54 + 5 * leg] = \
                    step["contact"][k][leg]
        else:
            reb_active[k, 48] = 1.0   # SRB min height only

    al_active = knot["td_mask"] * knot["is_terminal"][:, None]
    pen = PenaltyParams(
        reb_delta=reb_delta, reb_eps=reb_eps, reb_active=reb_active,
        reb_delta_min=reb_delta_min,
        al_lambda=np.full((N + 1, N_TCON), cfg.td_al_lambda),
        al_sigma=np.full((N + 1, N_TCON), cfg.td_al_sigma),
        al_active=al_active,
        al_sigma_max=np.asarray(cfg.td_al_sigma_max))

    meta = dict(wb_phases=wb_phases, srb_horizon=srb_horizon,
                n_knots=n_knots, contact_after_wb=contact_after_wb,
                wb_block=cfg.wb_block)
    return plan, pen, Xbar0, Ubar0, meta


def apply_transition_foot_handoff(plan_np, cfg: MHPCConfig, x_transition,
                                  model, ground_height=0.0):
    """Transition-frozen foot handoff for the SRB tail
    (MHPCFootStep.h:26-57, updateFootPosAtTransition/updateFootPositions):
    feet in contact at the WB->SRB handoff keep the ACTUAL (solved) WB foot
    XY, frozen while the foot stays in contact, instead of the reference
    placement; z is the ground height.  Mutates plan_np.step.pf_ref in
    place on the SRB steps.  `model` is the whole-body model
    (`wbm.load_model`).

    The reference computes this but its getFootPositions returns the
    reference placements anyway (MHPCFootStep.h:59-65), so it is opt-in
    (MHPCRuntime(foot_handoff=True)), as in the JAX package.
    """
    x = torch.as_tensor(np.asarray(x_transition), dtype=model.mass.dtype,
                        device=model.mass.device)
    pf = wbm.foot_positions(model, x).cpu().numpy()
    step = plan_np.step
    N = step.active.shape[0]
    frozen = None
    for k in range(cfg.wb_block, N):
        if step.active[k] < 1 or step.model_id[k] != 1:
            continue
        rc = np.asarray(step.ref_contact[k])
        if frozen is None:
            frozen = rc > 0        # feet in contact at the handoff
        for leg in range(4):
            if frozen[leg] and rc[leg] > 0:
                step.pf_ref[k][3 * leg:3 * leg + 2] = pf[leg][:2]
                step.pf_ref[k][3 * leg + 2] = ground_height
            else:
                frozen[leg] = False   # contact broke: reference placements
    return plan_np


# ------------------------------------------------------------------
# Problem functions (batched torch, consumed by the solver)
# ------------------------------------------------------------------

# friction pyramid facets per leg (MHPCConstraint.cpp)
_FACETS = np.array([[0.0, 0.0, 1.0],
                    [-1.0, 0.0, MU_WB],
                    [1.0, 0.0, MU_WB],
                    [0.0, -1.0, MU_WB],
                    [0.0, 1.0, MU_WB]])
_FBLK = np.zeros((20, 12))
for _leg in range(4):
    _FBLK[5 * _leg:5 * _leg + 5, 3 * _leg:3 * _leg + 3] = _FACETS


def _con_partials_np(mode):
    """Constant (gx [93, 36], gu [93, 12], gy [93, 12]) of path_con
    (mhpc_problem.py:786-808): the GRF pyramid acts on y for WB, on u for
    SRB."""
    gx = np.zeros((N_PCON, XS))
    gu = np.zeros((N_PCON, US))
    gy = np.zeros((N_PCON, YS))
    I12 = np.eye(12)
    gu[0:12], gu[12:24] = I12, -I12
    gx[24:36, 6:18], gx[36:48, 6:18] = I12, -I12
    gx[48, 2] = 1.0
    gx[69:81, 24:36], gx[81:93, 24:36] = I12, -I12
    if mode == "wb":
        gy[49:69] = _FBLK
    else:
        gu[49:69] = _FBLK
    return gx, gu, gy


class _Consts:
    """Numpy constants made once per dtype and device of the tensors they
    meet, so that no call copies them from the host again."""

    def __init__(self, **arrays):
        self._np = arrays
        self._made = {}

    def __call__(self, like):
        key = (like.dtype, like.device)
        if key not in self._made:
            self._made[key] = types.SimpleNamespace(**{
                k: torch.as_tensor(v, dtype=like.dtype, device=like.device)
                for k, v in self._np.items()})
        return self._made[key]


def _bcast(X, *arrays):
    """Plan arrays [n, ...] expanded to the batch of X [B, n, xs]."""
    lead = X.shape[:-1]
    return [a.expand(lead + a.shape[1:]) for a in arrays]


def _diag(v, lead):
    return torch.diag_embed(v).expand(lead + (v.shape[-1],) * 2)


def _path_con(c, x, u, f, h_min):
    """g [..., 93] with the GRF pyramid on f [..., 12]."""
    g_tq = torch.cat([u + TORQUE_LIMIT, TORQUE_LIMIT - u], -1)
    qJ = x[..., 6:18]
    g_j = torch.cat([qJ - c.lb, c.ub - qJ], -1)
    g_h = x[..., 2:3] - h_min
    g_grf = (f.unflatten(-1, (4, 3)) @ c.facets.mT).flatten(-2)
    qJd = x[..., 24:36]
    g_jv = torch.cat([qJd + JOINT_SPEED_LIMIT, JOINT_SPEED_LIMIT - qJd], -1)
    return torch.cat([g_tq, g_j, g_h, g_grf, g_jv], -1)


def _path_con_partials(c, X):
    """The constant (gx, gu, gy) of _con_partials_np, expanded to X's
    batch."""
    lead = X.shape[:-1]
    return tuple(a.expand(lead + a.shape) for a in (c.gx, c.gu, c.gy))


def _zero_pos_cols(J):
    """The reference's zeroed-position-column Jacobian quirk
    (MHPCCost.cpp:54-56): d prel/dq kills the base-translation columns."""
    return torch.cat([torch.zeros_like(J[..., 0:3]), J[..., 3:]], -1)


def _gn(J, w, r):
    """Gauss-Newton pieces of 0.5 sum_fi w_fi r_fi^2 with dr/dz = J
    [..., 4, 3, n]: (J^T (w r) [..., n], J^T diag(w) J [..., n, n])."""
    Jf = J.flatten(-3, -2)
    wf = w.flatten(-2)
    g = (Jf.mT @ (wf * r.flatten(-2))[..., None])[..., 0]
    return g, (Jf * wf[..., None]).mT @ Jf


def _ad_dyn_partials(dyn):
    """A, B, C, D as the forward-mode Jacobian of dyn (xnext and y) in
    (x, u), each knot on its own."""
    def dyn_partials(X, U, sd):
        Jx, Jy = rbda.batched_jacobian(
            lambda z: dyn(z[..., :XS], z[..., XS:], sd), torch.cat([X, U], -1))
        return Jx[..., :XS], Jx[..., XS:], Jy[..., :XS], Jy[..., XS:]
    return dyn_partials


def _make_wb_fns(cfg: MHPCConfig, lm):
    """The WB segment's batched functions on the whole-body model `lm`
    (the JAX lane overrides, mhpc_lane.py:200-498, with the batch
    leading)."""
    bg = float(cfg.BG_alpha)
    consts = _Consts(
        q=cfg.wb_q, r=cfg.wb_r, qf=cfg.wb_qf, reg=cfg.qfoot_reg,
        swp=cfg.qfoot_swing_pos, swv=cfg.qfoot_swing_vel,
        bm=BODY_MASK36, eye=np.eye(XS), lb=np.tile(JOINT_LB, 4),
        ub=np.tile(JOINT_UB, 4), facets=_FACETS,
        **dict(zip(("gx", "gu", "gy"), _con_partials_np("wb"))))

    def foot_quantities(X):
        """(pf, vf [..., 4, 3], J, Jv_q = d vf / dq [..., 4, 3, 18])."""
        q, v = X[..., :NQ], X[..., NQ:]
        J = wb_lane.foot_jacobians_lane(lm, q)
        pf = wb_lane.foot_positions_lane(lm, q)
        vf = (J @ v[..., None, :, None])[..., 0]
        Jv_q = wb_lane.jac_lane(
            lambda q_: wb_lane.foot_velocities_lane(lm, q_, v), q)
        return pf, vf, J, Jv_q

    def prel_err(X, pf, pf_ref, com_ref):
        """(pf - pcom) - (pf_ref - com_ref), [..., 4, 3]."""
        return (pf - X[..., None, 0:3]) \
            - (pf_ref.unflatten(-1, (4, 3)) - com_ref[..., None, :])

    def dyn(X, U, sd):
        dt, c = _bcast(X, sd.dt, sd.contact)
        return wb_lane.wb_dynamics_lane(lm, X, U, dt, c, bg)

    def dyn_partials(X, U, sd):
        dt, c = _bcast(X, sd.dt, sd.contact)
        return wb_lane.wb_dyn_partials_lane(lm, X, U, dt, c, bg)

    def reset_masks(X, sd):
        c, cn, ms = _bcast(X, sd.contact, sd.contact_next, sd.model_switch)
        has_imp = (cn - c).amax(-1) > 0.5
        return (1.0 - c) * cn, has_imp, ms > 0

    def reset(X, sd):
        """Impact on new contacts, then the WB->SRB body-mask projection at
        the model switch (MHPCReset.cpp:4-28)."""
        k = consts(X)
        imp_mask, has_imp, switch = reset_masks(X, sd)
        q, v = X[..., :NQ], X[..., NQ:]
        v_post, _ = wb_lane.impulse_dynamics_lane(lm, q, v, imp_mask)
        xr = torch.cat([q, torch.where(has_imp[..., None], v_post, v)], -1)
        return torch.where(switch[..., None], xr * k.bm, xr)

    def reset_partial(X, sd):
        """Impact Jacobian from the factored impulse KKT (WBM.cpp:508-543)
        and the diagonal model-switch projection."""
        k = consts(X)
        imp_mask, has_imp, switch = reset_masks(X, sd)
        q, v = X[..., :NQ], X[..., NQ:]
        dvq, dvv = wb_lane.impulse_dynamics_partials_lane(lm, q, v, imp_mask)
        top = k.eye[:NQ].expand(X.shape[:-1] + (NQ, XS))
        P = torch.cat([top, torch.cat([dvq, dvv], -1)], -2)
        P = torch.where(has_imp[..., None, None], P, k.eye)
        return torch.where(switch[..., None, None], k.bm[:, None] * P, P)

    def run_cost(X, U, Y, sd):
        """Tracking + WBFootPlaceReg + SwingFootPos + SwingFootVel
        (MHPCCost.cpp:4-62, 129-252), dt-scaled."""
        k = consts(X)
        dt, xr, ur, rc, pfr, comr, vfr = _bcast(
            X, sd.dt, sd.x_ref, sd.u_ref, sd.ref_contact, sd.pf_ref,
            sd.com_ref, sd.vf_ref)
        dx, du = X - xr, U - ur
        l = 0.5 * (k.q * dx * dx).sum(-1) + 0.5 * (k.r * du * du).sum(-1)
        q, v = X[..., :NQ], X[..., NQ:]
        d = prel_err(X, wb_lane.foot_positions_lane(lm, q), pfr, comr)
        dv = wb_lane.foot_velocities_lane(lm, q, v) \
            - vfr.unflatten(-1, (4, 3))
        c_st = rc[..., None]
        c_sw = 1.0 - c_st
        l = l + 0.5 * (c_st * d * d * k.reg).sum((-2, -1))
        l = l + 0.5 * (c_sw * d * d * k.swp).sum((-2, -1))
        l = l + 0.5 * (c_sw * dv * dv * k.swv).sum((-2, -1))
        return l * dt

    def run_cost_partials(X, U, Y, sd):
        """Tracking partials plus the Gauss-Newton foot-cost partials with
        the zeroed-position-column quirk and the swing-velocity term on
        [dvf/dq, J] (mhpc_lane.py:95-126)."""
        k = consts(X)
        lead = X.shape[:-1]
        dt, xr, ur, rc, pfr, comr, vfr = _bcast(
            X, sd.dt, sd.x_ref, sd.u_ref, sd.ref_contact, sd.pf_ref,
            sd.com_ref, sd.vf_ref)
        dtc = dt[..., None]
        pf, vf, J, Jv_q = foot_quantities(X)
        d = prel_err(X, pf, pfr, comr)
        rc3 = rc[..., None]
        w_pos = rc3 * k.reg + (1.0 - rc3) * k.swp
        lq, lqq = _gn(_zero_pos_cols(J), w_pos, d)
        w_vel = (1.0 - rc3) * k.swv
        fx, fxx = _gn(torch.cat([Jv_q, J], -1), w_vel,
                      vf - vfr.unflatten(-1, (4, 3)))
        fx = fx + torch.cat([lq, torch.zeros_like(lq)], -1)
        fxx = fxx + torch.nn.functional.pad(lqq, (0, NQ, 0, NQ))
        lx = dtc * (k.q * (X - xr) + fx)
        lxx = dtc[..., None] * (torch.diag_embed(k.q) + fxx)
        lu = dtc * k.r * (U - ur)
        luu = dtc[..., None] * _diag(k.r, lead)
        return (lx, lu, X.new_zeros(lead + (YS,)), lxx, luu,
                X.new_zeros(lead + (US, XS)), X.new_zeros(lead + (YS, YS)))

    def term_cost(X, kd):
        """Terminal tracking + WBFootPlaceReg terminal (stance) +
        TDVelocityPenalty (MHPCCost.cpp:65-86, 255-291)."""
        k = consts(X)
        xr, rc, pfr, comr, td = _bcast(X, kd.x_ref, kd.ref_contact,
                                       kd.pf_ref, kd.com_ref, kd.td_mask)
        dx = X - xr
        phi = 0.5 * (k.qf * dx * dx).sum(-1)
        q, v = X[..., :NQ], X[..., NQ:]
        d = prel_err(X, wb_lane.foot_positions_lane(lm, q), pfr, comr)
        phi = phi + 0.5 * (rc[..., None] * d * d * k.reg).sum((-2, -1))
        vz = wb_lane.foot_velocities_lane(lm, q, v)[..., 2]
        return phi + 0.5 * (td * vz * vz).sum(-1)

    def term_cost_partials(X, kd):
        """Foot-place reg terminal partials with the reference's factor 2
        (MHPCCost.cpp:89-118) and the touchdown-velocity rows
        (MHPCCost.cpp:271-291)."""
        k = consts(X)
        xr, rc, pfr, comr, td = _bcast(X, kd.x_ref, kd.ref_contact,
                                       kd.pf_ref, kd.com_ref, kd.td_mask)
        pf, vf, J, Jv_q = foot_quantities(X)
        d = prel_err(X, pf, pfr, comr)
        lq, lqq = _gn(_zero_pos_cols(J), rc[..., None] * k.reg, d)
        Jrow = torch.cat([Jv_q[..., 2, :], J[..., 2, :]], -1)   # [..., 4, 36]
        phix = k.qf * (X - xr) \
            + torch.cat([2.0 * lq, torch.zeros_like(lq)], -1) \
            + (Jrow.mT @ (td * vf[..., 2])[..., None])[..., 0]
        phixx = torch.diag_embed(k.qf) \
            + torch.nn.functional.pad(2.0 * lqq, (0, NQ, 0, NQ)) \
            + (Jrow * td[..., None]).mT @ Jrow
        return phix, phixx

    def path_con(X, U, Y, sd):
        return _path_con(consts(X), X, U, Y, MIN_HEIGHT_WB)

    def path_con_partials(X, U, Y, sd):
        return _path_con_partials(consts(X), X)

    def term_con(X, kd):
        """WBTouchDown (MHPCConstraint.cpp:253-288): foot height."""
        return wb_lane.foot_positions_lane(lm, X[..., :NQ])[..., 2]

    def term_con_partials(X, kd):
        J = wb_lane.foot_jacobians_lane(lm, X[..., :NQ])
        return torch.cat([J[..., 2, :], torch.zeros_like(J[..., 2, :])], -1)

    return ProblemFns(
        dyn=dyn, dyn_partials=dyn_partials, reset=reset,
        reset_partial=reset_partial, run_cost=run_cost,
        run_cost_partials=run_cost_partials, term_cost=term_cost,
        term_cost_partials=term_cost_partials, path_con=path_con,
        path_con_partials=path_con_partials, term_con=term_con,
        term_con_partials=term_con_partials)


def _make_srb_fns(cfg: MHPCConfig):
    """The SRB tail's batched functions on the embedded 12-dim body state
    (mhpc_problem.py:419-425, 500-537, 604-615, 698-740, 810-817).  Spans
    (`utils/tracing.py`, host only): `srb.partials` around `dyn_partials`,
    `srb.step` around `dyn`; the counters `srb.lin_knots` and
    `srb.step_knots` add the knots each call linearizes and steps."""
    q36, qf36 = np.zeros(XS), np.zeros(XS)
    q36[BODY_DIMS], qf36[BODY_DIMS] = cfg.srb_q, cfg.srb_qf
    consts = _Consts(
        q=q36, qf=qf36, r=cfg.srb_r, eye=np.eye(XS),
        lb=np.tile(JOINT_LB, 4), ub=np.tile(JOINT_UB, 4), facets=_FACETS,
        **dict(zip(("gx", "gu", "gy"), _con_partials_np("srb"))))
    bd_on = {}

    def body_dims(X):
        if X.device not in bd_on:
            bd_on[X.device] = torch.as_tensor(BODY_DIMS, device=X.device)
        return bd_on[X.device]

    def body(X, sd):
        dt, pfr, rc = _bcast(X, sd.dt, sd.pf_ref, sd.ref_contact)
        return X[..., body_dims(X)], dt, pfr, rc

    def dyn(X, U, sd):
        """Forward-Euler SRB step at the body dims (SRBM.h:43-49); the dead
        dims are zero."""
        with tracing.span("srb.step"):
            tracing.count("srb.step_knots", math.prod(X.shape[:-1]))
            x12, dt, pfr, rc = body(X, sd)
            xn = x12 + dt[..., None] * srb.dynamics_continuous(x12, U, pfr,
                                                               rc)
            z = X.new_zeros(X.shape[:-1] + (12,))
            return (torch.cat([xn[..., :6], z, xn[..., 6:], z], -1),
                    X.new_zeros(X.shape[:-1] + (YS,)))

    def dyn_partials(X, U, sd):
        """SRB Jacobians on the 12-dim core, embedded at the body dims
        (SRBM.h:66-75 + StateProjection)."""
        with tracing.span("srb.partials"):
            tracing.count("srb.lin_knots", math.prod(X.shape[:-1]))
            x12, dt, pfr, rc = body(X, sd)
            A12, B12 = srb.dynamics_partials(x12, U, pfr, rc, dt)
            lead = X.shape[:-1]
            b = body_dims(X)
            A = X.new_zeros(lead + (XS, XS))
            A[..., b[:, None], b[None, :]] = A12
            Bm = X.new_zeros(lead + (XS, US))
            Bm[..., b, :] = B12
            return (A, Bm, X.new_zeros(lead + (YS, XS)),
                    X.new_zeros(lead + (YS, US)))

    def reset(X, sd):
        return X

    def reset_partial(X, sd):
        return consts(X).eye.expand(X.shape[:-1] + (XS, XS))

    def run_cost(X, U, Y, sd):
        k = consts(X)
        dt, xr, ur = _bcast(X, sd.dt, sd.x_ref, sd.u_ref)
        dx, du = X - xr, U - ur
        return (0.5 * (k.q * dx * dx).sum(-1)
                + 0.5 * (k.r * du * du).sum(-1)) * dt

    def run_cost_partials(X, U, Y, sd):
        k = consts(X)
        lead = X.shape[:-1]
        dt, xr, ur = _bcast(X, sd.dt, sd.x_ref, sd.u_ref)
        dtc = dt[..., None]
        return (dtc * k.q * (X - xr), dtc * k.r * (U - ur),
                X.new_zeros(lead + (YS,)),
                dtc[..., None] * _diag(k.q, lead),
                dtc[..., None] * _diag(k.r, lead),
                X.new_zeros(lead + (US, XS)), X.new_zeros(lead + (YS, YS)))

    def term_cost(X, kd):
        dx = X - _bcast(X, kd.x_ref)[0]
        return 0.5 * (consts(X).qf * dx * dx).sum(-1)

    def term_cost_partials(X, kd):
        k = consts(X)
        return (k.qf * (X - _bcast(X, kd.x_ref)[0]),
                _diag(k.qf, X.shape[:-1]))

    def path_con(X, U, Y, sd):
        return _path_con(consts(X), X, U, U, MIN_HEIGHT_SRB)

    def path_con_partials(X, U, Y, sd):
        return _path_con_partials(consts(X), X)

    # no AL terminal constraints on the SRB tail (pen.al_active is 0 on its
    # knots)
    def term_con(X, kd):
        return X.new_zeros(X.shape[:-1] + (N_TCON,))

    def term_con_partials(X, kd):
        return X.new_zeros(X.shape[:-1] + (N_TCON, XS))

    return ProblemFns(
        dyn=dyn, dyn_partials=dyn_partials, reset=reset,
        reset_partial=reset_partial, run_cost=run_cost,
        run_cost_partials=run_cost_partials, term_cost=term_cost,
        term_cost_partials=term_cost_partials, path_con=path_con,
        path_con_partials=path_con_partials, term_con=term_con,
        term_con_partials=term_con_partials)


def _make_joint_fns(wbf, srbf):
    """The JAX joint mode (mhpc_problem.py:463-864) from the two models'
    functions: every callable evaluates both and selects on model_id, with
    torch.where, as jnp.where does, so that a non-finite value of the
    branch not taken (the WB KKT on a projected SRB state, in f32) stays
    out; the GRF output is the WB one on WB knots and zero elsewhere, the
    dynamics partials the forward-mode Jacobian of the selected dynamics,
    the reset and the terminal constraint the WB ones on every knot."""
    def is_wb(X, pd):
        return _bcast(X, pd.model_id)[0] == 0

    def select(wb, a, b):
        if isinstance(a, tuple):
            return tuple(select(wb, x, y) for x, y in zip(a, b))
        return torch.where(wb.reshape(wb.shape + (1,) * (a.dim() - wb.dim())),
                           a, b)

    def dyn(X, U, sd):
        wb = is_wb(X, sd)
        xn_wb, grf = wbf.dyn(X, U, sd)
        return (select(wb, xn_wb, srbf.dyn(X, U, sd)[0]),
                select(wb, grf, torch.zeros_like(grf)))

    def both(name):
        def f(X, *args):
            return select(is_wb(X, args[-1]), getattr(wbf, name)(X, *args),
                          getattr(srbf, name)(X, *args))
        return f

    return ProblemFns(
        dyn=dyn, dyn_partials=_ad_dyn_partials(dyn), reset=wbf.reset,
        reset_partial=wbf.reset_partial, **{n: both(n) for n in (
            "run_cost", "run_cost_partials", "term_cost",
            "term_cost_partials", "path_con", "path_con_partials")},
        term_con=wbf.term_con, term_con_partials=wbf.term_con_partials)


MODES = ("joint", "wb", "srb")


def make_mhpc_fns(cfg: MHPCConfig, model, mode="joint") -> ProblemFns:
    """Problem functions of the cascade on the whole-body model `model`
    (`wbm.load_model`, at the solve's dtype and device; not used by
    mode="srb").

    mode="joint" (the JAX package's default): every callable handles both
    models through a model_id select, evaluating both on every knot.
    mode="wb" / "srb": one model's functions for the segmented solver
    (`make_mhpc_fns_segmented`).  Joint mode takes its dynamics partials
    by forward-mode AD through the select, as the JAX joint mode does; its
    reset partials, and mode "wb"'s dynamics and reset partials, are the
    closed-form factored-KKT assembly."""
    if mode not in MODES:
        raise ValueError(f"make_mhpc_fns: unknown mode {mode!r} (one of "
                         f"{', '.join(MODES)})")
    cfg = _default_weights(dataclasses.replace(cfg))
    if mode == "srb":
        return _make_srb_fns(cfg)
    if model is None:
        raise ValueError(f"make_mhpc_fns: mode {mode!r} needs the whole-body "
                         "model (wbm.load_model(urdf_path, ...))")
    if mode == "wb":
        return _make_wb_fns(cfg, model)
    return _make_joint_fns(_make_wb_fns(cfg, model), _make_srb_fns(cfg))


def make_mhpc_fns_segmented(cfg: MHPCConfig, model) -> SegmentedFns:
    """Two-segment problem functions for the cascade: WB steps
    [0, wb_block), SRB tail [wb_block, n_steps_max).  Requires the plan
    from build_mhpc_plan (carry-pad layout).  `model`: the whole-body
    model at the solve's dtype and device."""
    return SegmentedFns(
        counts=(cfg.wb_block, cfg.n_steps_max - cfg.wb_block),
        fns=(make_mhpc_fns(cfg, model, "wb"),
             make_mhpc_fns(cfg, None, "srb")))

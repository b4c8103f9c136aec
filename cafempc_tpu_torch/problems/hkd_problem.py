"""HKD-MPC problem: flat knot-plan construction + batched problem functions
(port of `cafempc_tpu/problems/hkd_problem.py`).

  * phase discovery by contact scanning      (HKDProblem.cpp:26-68)
  * per-phase tracking + foot-reg costs      (HKDCost.h:8-100)
  * GRF friction-pyramid ReB constraint      (HKDConstraints.cpp:6-66)
  * touchdown AL constraint + HKD reset      (HKDConstraints.cpp:68-171,
                                              HKDReset.h:41-136)

The plan builder and the settings loader are host-side numpy, copied here
because the JAX module imports jax at its top.  `make_hkd_fns()` returns
torch functions that take the whole batch at once: states [B, n, 24]
against plan slices [n, ...].  The dynamics partials are the closed form
(`hkd.dynamics_partials`; forward-mode AD, `hkd.dynamics_partials_ad`, is
the tests' reference for it).  The fused LQ hook computes its own.
"""
import dataclasses
import re

import numpy as np
import torch

from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.reference.quad_reference import (
    QuadReference, hkd_control_ref_at, hkd_state_ref_at)
from cafempc_tpu_torch.solver.hsddp import ProblemFns
from cafempc_tpu_torch.solver.plan import (KnotData, KnotPlan,
                                           PenaltyParams, StepData)

N_PCON = 20   # 5 friction facets x 4 legs
N_TCON = 4    # touchdown height per leg
MU_FRIC = 0.7  # HKDConstraints.h:17
GROUND_HEIGHT = 0.0


@dataclasses.dataclass
class HKDConfig:
    """(HKDMPC.cpp:26-29)"""
    plan_duration: float = 0.6
    dt_sim: float = 0.01
    nsteps_between_mpc: int = 2
    n_steps_max: int = 72          # padded flat-plan length
    # constraint params (HKDMPC/settings/constraint_params.info)
    grf_reb_delta: float = 0.1
    grf_reb_delta_min: float = 0.1
    grf_reb_eps: float = 0.5
    td_al_sigma: float = 20.0
    td_al_sigma_max: float = 1e4
    td_al_lambda: float = 0.0


def load_hkd_constraint_params(fname, cfg: HKDConfig):
    """`cfg` with the ReB and touchdown-AL parameters of the reference's
    HKDMPC/settings/constraint_params.info: its `GRF_ReB` block (delta,
    delta_min, eps) and `TD_AL` block (sigma, sigma_max, lambda).  A block
    or key the file lacks keeps the value of `cfg`."""
    with open(fname) as fh:
        txt = fh.read()

    def block(name):
        m = re.search(name + r"\s*\{(.*?)\}", txt, re.S)
        if not m:
            return {}
        out = {}
        for ln in m.group(1).splitlines():
            p = ln.split()
            if len(p) == 2:
                out[p[0]] = float(p[1])
        return out

    g = block("GRF_ReB")
    t = block("TD_AL")
    return dataclasses.replace(
        cfg,
        grf_reb_delta=g.get("delta", cfg.grf_reb_delta),
        grf_reb_delta_min=g.get("delta_min", cfg.grf_reb_delta_min),
        grf_reb_eps=g.get("eps", cfg.grf_reb_eps),
        td_al_sigma=t.get("sigma", cfg.td_al_sigma),
        td_al_sigma_max=t.get("sigma_max", cfg.td_al_sigma_max),
        td_al_lambda=t.get("lambda", cfg.td_al_lambda))


# ------------------------------------------------------------------
# Phase discovery + flat plan build (host-side numpy)
# ------------------------------------------------------------------

def discover_phases(quad_ref: QuadReference, plan_duration, dt):
    """Contact scan -> list of (start_t, end_t, horizon, contact[4])
    (HKDProblem.cpp:40-68)."""
    phases = []
    t = 0.0
    c_prev = np.array(quad_ref.contact_at_t(0.0))
    start = 0.0
    eps = 1e-6
    while t <= plan_duration + eps:
        c = np.array(quad_ref.contact_at_t(t))
        if (c != c_prev).any() or abs(t - plan_duration) < eps:
            horizon = int(round((t - start) / dt))
            if horizon > 0:
                phases.append((start, t, horizon, c_prev.copy()))
            c_prev = c
            start = t
        t += dt
    return phases


def build_hkd_plan(quad_ref: QuadReference, cfg: HKDConfig,
                   dt_mpc_ahead=None):
    """Build the flat plan (numpy KnotPlan), initial trajectory, and
    penalty parameter init for the current reference window.

    Returns (plan, pen, Xbar0, Ubar0, meta) where meta carries phase info
    for the runtime (contacts, horizons, durations).
    """
    dt = cfg.dt_sim
    N = cfg.n_steps_max
    phases = discover_phases(quad_ref, cfg.plan_duration, dt)
    n_ph = len(phases)

    # contact after the plan end — used for the last phase's touchdown
    # detection (HKDProblem.cpp:286)
    dt_ahead = dt_mpc_ahead if dt_mpc_ahead is not None \
        else cfg.nsteps_between_mpc * dt
    contact_after = np.array(quad_ref.contact_at_t(
        min(cfg.plan_duration + dt_ahead, quad_ref.dur)))

    xs, us, ys = hkd.XS, hkd.US, 0
    step = dict(
        active=np.zeros(N), is_reset=np.zeros(N), dt=np.full(N, dt),
        t=np.zeros(N), contact=np.zeros((N, 4)),
        contact_next=np.zeros((N, 4)), x_ref=np.zeros((N, xs)),
        u_ref=np.zeros((N, us)), y_ref=np.zeros((N, ys)),
        pf_ref=np.zeros((N, 12)), com_ref=np.zeros((N, 3)),
        vf_ref=np.zeros((N, 12)), ref_contact=np.zeros((N, 4)),
        model_id=np.zeros(N), model_switch=np.zeros(N),
        q_diag=np.zeros((N, 0)), r_diag=np.zeros((N, 0)))
    knot = dict(
        active=np.zeros(N + 1), is_terminal=np.zeros(N + 1),
        td_mask=np.zeros((N + 1, 4)), contact=np.zeros((N + 1, 4)),
        ref_contact=np.zeros((N + 1, 4)), model_id=np.zeros(N + 1),
        qf_diag=np.zeros((N + 1, 0)),
        x_ref=np.zeros((N + 1, xs)), pf_ref=np.zeros((N + 1, 12)),
        com_ref=np.zeros((N + 1, 3)), t=np.zeros(N + 1))
    Xbar0 = np.zeros((N + 1, xs))
    Ubar0 = np.zeros((N, us))

    t0 = phases[0][0]
    j = 0  # flat step index

    def fill_common(j, t):
        rec = quad_ref.record_at_t(t)
        step["t"][j] = t - t0
        step["x_ref"][j] = hkd_state_ref_at(quad_ref, t)
        step["u_ref"][j] = hkd_control_ref_at(quad_ref, t)
        step["pf_ref"][j] = rec["foot_placements"]
        step["com_ref"][j] = rec["body_state"][0:3]
        step["vf_ref"][j] = rec["foot_velocities"]
        step["ref_contact"][j] = rec["contact"]

    for ip, (ts, te, hor, contact) in enumerate(phases):
        for k in range(hor):
            t = ts + k * dt
            step["active"][j] = 1.0
            step["contact"][j] = contact
            fill_common(j, t)
            knot["active"][j] = 1.0
            knot["t"][j] = t - t0
            knot["contact"][j] = contact
            knot["x_ref"][j] = step["x_ref"][j]
            knot["pf_ref"][j] = step["pf_ref"][j]
            knot["com_ref"][j] = step["com_ref"][j]
            Xbar0[j] = hkd_state_ref_at(quad_ref, t)
            Ubar0[j] = 0.0
            j += 1
        # phase-terminal knot
        knot["active"][j] = 1.0
        knot["is_terminal"][j] = 1.0
        knot["t"][j] = te - t0
        knot["contact"][j] = contact
        rec = quad_ref.record_at_t(te)
        knot["x_ref"][j] = hkd_state_ref_at(quad_ref, te)
        knot["pf_ref"][j] = rec["foot_placements"]
        knot["com_ref"][j] = rec["body_state"][0:3]
        Xbar0[j] = hkd_state_ref_at(quad_ref, te)
        contact_next = (phases[ip + 1][3] if ip + 1 < n_ph
                        else contact_after)
        knot["td_mask"][j] = ((contact == 0) & (contact_next == 1)) \
            .astype(float)
        if ip + 1 < n_ph:
            # reset step to the next phase-start knot
            step["active"][j] = 1.0
            step["is_reset"][j] = 1.0
            step["contact"][j] = contact
            step["contact_next"][j] = contact_next
            fill_common(j, te)
            Ubar0[j] = 0.0
            j += 1

    n_knots = j + 1
    # pad Xbar with last active state (keeps padded dynamics sane)
    Xbar0[n_knots:] = Xbar0[n_knots - 1]

    plan = KnotPlan(StepData(**step), KnotData(**knot))

    reb_active = np.zeros((N, N_PCON))
    for k in range(N):
        if step["active"][k] and not step["is_reset"][k]:
            for leg in range(4):
                reb_active[k, 5 * leg:5 * leg + 5] = step["contact"][k][leg]
    al_active = knot["td_mask"] * knot["is_terminal"][:, None]
    pen = PenaltyParams(
        reb_delta=np.full((N, N_PCON), cfg.grf_reb_delta),
        reb_eps=np.full((N, N_PCON), cfg.grf_reb_eps),
        reb_active=reb_active,
        reb_delta_min=np.asarray(cfg.grf_reb_delta_min),
        al_lambda=np.full((N + 1, N_TCON), cfg.td_al_lambda),
        al_sigma=np.full((N + 1, N_TCON), cfg.td_al_sigma),
        al_active=al_active,
        al_sigma_max=np.asarray(cfg.td_al_sigma_max))

    meta = dict(phases=phases, n_knots=n_knots,
                contact_after=contact_after)
    return plan, pen, Xbar0, Ubar0, meta


def pen_to_device(pen: PenaltyParams, dtype=torch.float32, device="cuda"):
    """The host penalty parameters of `build_hkd_plan` as tensors of `dtype`
    on `device`."""
    return PenaltyParams(*[torch.as_tensor(np.asarray(a), dtype=dtype,
                                           device=device) for a in pen])


# ------------------------------------------------------------------
# Problem functions (batched torch, consumed by the solver)
# ------------------------------------------------------------------

# friction pyramid facets per leg (HKDConstraints.cpp:17-22)
_FACETS = np.array([[0.0, 0.0, 1.0],
                    [-1.0, 0.0, MU_FRIC],
                    [1.0, 0.0, MU_FRIC],
                    [0.0, -1.0, MU_FRIC],
                    [0.0, 1.0, MU_FRIC]])


def _np_facets():
    """The friction-pyramid facets [5, 3] (numpy, a copy)."""
    return _FACETS.copy()


def _facets(dtype=torch.float64, device="cuda"):
    """The friction-pyramid facets [5, 3] as a tensor."""
    return torch.as_tensor(_FACETS, dtype=dtype, device=device)


# constant constraint Jacobian d g / d u (block-diag facets per leg)
_GU_CONST = np.zeros((N_PCON, 24))
for _leg in range(4):
    _GU_CONST[5 * _leg:5 * _leg + 5, 3 * _leg:3 * _leg + 3] = _FACETS

# foot-place reg placement: d prel/dx = c3 * (E_BLK - E_TILE) (HKDCost.h:61-68)
_E_PREL = np.zeros((12, 24))
for _leg in range(4):
    _E_PREL[3 * _leg:3 * _leg + 3, 12 + 3 * _leg:15 + 3 * _leg] = np.eye(3)
_E_PREL[:, 3:6] -= np.tile(np.eye(3), (4, 1))

_Q_BODY = np.array([1.0, 4.0, 4.0, 1.0, 1.0, 30.0,
                    1.0, 0.5, 0.2, 1.0, 1.0, 1.0])
_QF_SCALE = 20.0 * np.concatenate([
    np.array([1.0, 1.0, 2.0, 1.0, 1.0, 20.0, 1.0, 0.2, 0.1, 1.0, 1.0, 1.0]),
    0.01 * np.ones(12)])


def _tracking_weights(contact):
    """Contact-modulated diagonal weights (HKDCost.h:13-36):
    contact [..., 4] -> (q [..., 24], r [24], qf [..., 24])."""
    q_body = torch.as_tensor(_Q_BODY, dtype=contact.dtype,
                             device=contact.device)
    q_qJ = 0.1 * (1.0 - contact.repeat_interleave(3, dim=-1))
    q = torch.cat([q_body.expand(q_qJ.shape[:-1] + (12,)), q_qJ], dim=-1)
    r = torch.full((24,), 0.1, dtype=contact.dtype, device=contact.device)
    qf = torch.as_tensor(_QF_SCALE, dtype=contact.dtype,
                         device=contact.device) * q
    return q, r, qf


def _footreg_weights(contact):
    """Qfoot diag (HKDCost.h:52-70): 100 * contact on x,y per leg."""
    w = torch.stack([contact, contact, torch.zeros_like(contact)], dim=-1)
    return 100.0 * w.flatten(-2)


def _d_prel(x, pf_ref, com_ref):
    """prel - prel_ref for the foot-place regularization."""
    prel = x[..., 12:24] - x[..., 3:6].repeat(*([1] * (x.dim() - 1)), 4)
    prel_r = pf_ref - com_ref.repeat(*([1] * (com_ref.dim() - 1)), 4)
    return prel - prel_r


def _dprel_dx(contact):
    """d prel / dx [..., 12, 24]: contact mask times the constant
    placement matrix."""
    E = torch.as_tensor(_E_PREL, dtype=contact.dtype, device=contact.device)
    return contact.repeat_interleave(3, dim=-1).unsqueeze(-1) * E


def _diag(v):
    return torch.diag_embed(v)


def make_hkd_fns() -> ProblemFns:
    """Batched HKD problem functions.  Per-step functions take
    X/U [B, n, 24] and a StepData slice [n, ...]; per-knot functions take
    X [B, n, 24] and a KnotData slice."""
    def empty(x, *tail):
        return x.new_zeros(x.shape[:-1] + tail)

    def dyn(x, u, sd):
        return hkd.dynamics(x, u, sd.dt, sd.contact), empty(x, 0)

    def dyn_partials(x, u, sd):
        A, B = hkd.dynamics_partials(x, u, sd.dt, sd.contact)
        return A, B, empty(x, 0, 24), empty(x, 0, 24)

    def reset(x, sd):
        return hkd.reset_map(x, sd.contact, sd.contact_next)

    def reset_partial(x, sd):
        return hkd.reset_map_partial(x, sd.contact, sd.contact_next)

    def run_cost(x, u, y, sd):
        q, r, _ = _tracking_weights(sd.contact)
        dx = x - sd.x_ref
        du = u - sd.u_ref
        l = 0.5 * torch.sum(q * dx * dx, -1) + 0.5 * torch.sum(r * du * du, -1)
        d = _d_prel(x, sd.pf_ref, sd.com_ref)
        l = l + 0.5 * torch.sum(_footreg_weights(sd.contact) * d * d, -1)
        return l * sd.dt

    def run_cost_partials(x, u, y, sd):
        q, r, _ = _tracking_weights(sd.contact)
        dt = sd.dt.unsqueeze(-1)
        dtm = dt.unsqueeze(-1)
        lx = dt * q * (x - sd.x_ref)
        lu = dt * r * (u - sd.u_ref)
        lxx = dtm * _diag(q)
        luu = (dtm * _diag(r)).expand(lu.shape + (24,))
        lux = empty(x, 24, 24)
        # foot-place reg (HKDCost.cpp:22-36)
        d = _d_prel(x, sd.pf_ref, sd.com_ref)
        qf = _footreg_weights(sd.contact)
        D = _dprel_dx(sd.contact)
        lx = lx + dt * torch.einsum("...ci,...c->...i", D, qf * d)
        lxx = lxx + dtm * torch.einsum("...ci,...c,...cj->...ij", D, qf, D)
        return (lx, lu, empty(x, 0), lxx.expand(lx.shape + (24,)), luu, lux,
                empty(x, 0, 0))

    def term_cost(x, kd):
        _, _, qf = _tracking_weights(kd.contact)
        dx = x - kd.x_ref
        phi = 0.5 * torch.sum(qf * dx * dx, -1)
        # foot reg terminal (HKDCost.cpp:39-50): 10 * d'Qd (not 0.5)
        d = _d_prel(x, kd.pf_ref, kd.com_ref)
        return phi + 10.0 * torch.sum(_footreg_weights(kd.contact) * d * d,
                                      -1)

    def term_cost_partials(x, kd):
        _, _, qf = _tracking_weights(kd.contact)
        phix = qf * (x - kd.x_ref)
        d = _d_prel(x, kd.pf_ref, kd.com_ref)
        qfoot = _footreg_weights(kd.contact)
        D = _dprel_dx(kd.contact)
        phix = phix + 20.0 * torch.einsum("...ci,...c->...i", D, qfoot * d)
        phixx = _diag(qf) + 20.0 * torch.einsum("...ci,...c,...cj->...ij",
                                                D, qfoot, D)
        return phix, phixx.expand(phix.shape + (24,))

    def path_con(x, u, y, sd):
        """g = facets @ grf_leg per leg (HKDConstraints.cpp:36-53); stance
        masking happens via PenaltyParams.reb_active."""
        return torch.einsum("fi,...li->...lf", _facets(u.dtype, u.device),
                            u[..., 0:12].unflatten(-1, (4, 3))).flatten(-2)

    def path_con_partials(x, u, y, sd):
        gu = torch.as_tensor(_GU_CONST, dtype=u.dtype, device=u.device)
        shape = u.shape[:-1]
        return (empty(x, N_PCON, 24), gu.expand(shape + (N_PCON, 24)),
                empty(x, N_PCON, 0))

    def term_con(x, kd):
        """h_l = foot_z - ground for touchdown legs
        (HKDConstraints.cpp:79-120)."""
        return hkd.foot_heights(x) - GROUND_HEIGHT

    def term_con_partials(x, kd):
        return hkd.touchdown_height_partials(x)

    return ProblemFns(
        dyn=dyn, dyn_partials=dyn_partials, reset=reset,
        reset_partial=reset_partial, run_cost=run_cost,
        run_cost_partials=run_cost_partials, term_cost=term_cost,
        term_cost_partials=term_cost_partials, path_con=path_con,
        path_con_partials=path_con_partials, term_con=term_con,
        term_con_partials=term_con_partials)

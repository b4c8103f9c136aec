"""Knot-batched whole-body kinematics, dynamics and linearization (port of
the default path of `cafempc_tpu/models/wb_lane.py`).

The JAX module puts the flattened scenario x knot axis K last, for the
TPU's tiles.  Here K is the LEADING dimension, as everywhere in the port,
so the lane forms of FK, the mass matrix, gravity, the foot kinematics and
the Schur-complement KKT solve are `rbda`'s batched functions, and the
lane algebra (lanedot, lanemv, the unrolled lane Cholesky) is batched `@`,
`cholesky_ex` and `cholesky_solve`.  Shapes: q, v, tau [K, nd], x [K, 36],
u [K, 12], dt [K], contact [K, 4] (any leading dimensions work).

What is the lane module's own (WBM.cpp:459-505 structure):
  * the bias force as Jacobian-transpose Newton-Euler with qdd = 0, FIRST
    order in the FK derivatives, so the residual Jacobian below needs only
    second FK derivatives of per-body Jacobians;
  * M(q) x contracted per body (`Mv_lane`), so the q-directions never
    build the full M;
  * the factored-KKT derivative assembly: 18 q-directions and 18
    v-directions through the KKT residual (`jac_lane`, one jvp vmapped
    over the directions), then one multi-RHS application of the factored
    KKT matrix.
Each residual takes its per-body Jacobians, world inertias and foot
Jacobians, and their time derivatives, from ONE FK pass and its jvp along v
(`_kin`): the JAX module leaves merging the repeated FK passes to XLA.

The closed-form FK derivative bundle of the JAX module (`cf_bundle`,
CAFEMPC_WB_CF=1, off by default there) is not ported.
"""
import functools

import torch
from torch.func import jvp

from cafempc_tpu_torch.models import rbda, wbm
from cafempc_tpu_torch.models.rbda import _mv

NQ = 18


# The lane form runs on wbm's model, an `rbda.RBDAModel` (the JAX module's
# WBLaneModel holds the same constants).
load_lane_model = wbm.load_model

# Per-knot Jacobian [K, *out, n] of a function of x [K, n]: the JAX form
# returns the direction axis first and K last.
jac_lane = rbda.batched_jacobian

mass_matrix_lane = rbda.mass_matrix
gravity_force_lane = rbda.gravity_force
foot_positions_lane = rbda.foot_kinematics
foot_jacobians_lane = rbda.foot_jacobians
foot_velocities_lane = rbda.foot_velocities
foot_drift_lane = rbda.foot_drift
_kkt_schur_solve_lane = rbda._kkt_schur_solve
_kkt_partials_tail = rbda._kkt_partials_tail


def _kin(m, q):
    """One FK pass: (Jw, Jv [K, nb, 3, nd], Iw [K, nb, 3, 3], J [K, 12, nd])
    — every massy body's Jacobians and world inertia, and the stacked foot
    Jacobians."""
    R, p, aw = rbda.fk(m, q)
    _, Jw, Jv, Iw = rbda._body_jacobians(m, R, p, aw)
    J = rbda._point_jacobians_batch(m, p, aw, rbda._foot_points(m, R, p),
                                    m.fidx)
    return Jw, Jv, Iw, J.flatten(-3, -2)


def _kin_dt(m, q, v):
    """`_kin` and its time derivative along v (one jvp)."""
    return jvp(functools.partial(_kin, m), (q,), (v,))


def _per_body_mv(m, Jw, Jv, Iw, x):
    """sum_b Jw_b^T Iw_b Jw_b x + m_b Jv_b^T Jv_b x [K, nd]: M(q) x without
    M."""
    mass = m.mass[m.mb][:, None]
    xb = x[..., None, :]
    Lb = _mv(Iw, _mv(Jw, xb))                                # [K, nb, 3]
    return (_mv(Jw.mT, Lb) + _mv(Jv.mT, mass * _mv(Jv, xb))).sum(-2)


def _newton_euler(m, kin, dkin, v):
    """h(q, v) = sum_b [ Jv_b^T m_b a_b + Jw_b^T (dIw_b/dt w_b + Iw_b
    wdot_b) ] + g(q), with a_b = (dJv_b/dt) v and wdot_b = (dJw_b/dt) v
    (qdd = 0)."""
    Jw, Jv, Iw, _ = kin
    dJw, dJv, dIw, _ = dkin
    mass = m.mass[m.mb][:, None]
    vb = v[..., None, :]
    wb = _mv(Jw, vb)
    dLdt = _mv(dIw, wb) + _mv(Iw, _mv(dJw, vb))              # [K, nb, 3]
    h = (_mv(Jw.mT, dLdt) + _mv(Jv.mT, mass * _mv(dJv, vb))).sum(-2)
    return h + rbda._gravity_from_jacobians(m, Jv)


def Mv_lane(m, q, v):
    """r(q) = M(q) v with v held constant, contracted per body: the
    q-directions through it stay [dirs, K, nb, 3, nd], never
    [dirs, K, nd, nd]."""
    Jw, Jv, Iw, _ = _kin(m, q)
    return _per_body_mv(m, Jw, Jv, Iw, v)


def bias_force_lane(m, q, v):
    """h(q, v) = C v + g by Jacobian-transpose Newton-Euler with qdd = 0
    (the structure Pinocchio's RNEA derivatives exploit, WBM.cpp:459-505
    upstream); every d/dt is one jvp along v."""
    kin, dkin = _kin_dt(m, q, v)
    return _newton_euler(m, kin, dkin, v)


def _dyn_terms(m, q, v, cmask3, bg_alpha):
    """From one FK pass and its jvp along v: (Jw, Jv, Iw, Jm, h, gamma_m)
    with Jm the contact-masked foot Jacobians and gamma_m = (Jdot v +
    2 bg_alpha J v) masked."""
    kin, dkin = _kin_dt(m, q, v)
    Jw, Jv, Iw, J = kin
    gamma_m = (_mv(dkin[3], v) + 2.0 * bg_alpha * _mv(J, v)) * cmask3
    return (Jw, Jv, Iw, J * cmask3[..., None],
            _newton_euler(m, kin, dkin, v), gamma_m)


def contact_kkt_dynamics_lane(m, q, v, tau, contact, bg_alpha,
                              damping=1e-12):
    """(qdd [K, nd], GRF [K, 12]): rbda.contact_kkt_dynamics with the
    Newton-Euler bias force.  contact [K, 4] float mask, tau [K, nd] the
    full generalized force."""
    cmask3, Sdiag = rbda._masks(contact, damping)
    Jw, Jv, Iw, Jm, h, gamma_m = _dyn_terms(m, q, v, cmask3, bg_alpha)
    M = rbda._mass_from_jacobians(m, Jw, Jv, Iw)
    qdd, b = _kkt_schur_solve_lane(M, Jm, Sdiag, (tau - h)[..., None],
                                   -gamma_m[..., None])
    return qdd[..., 0], -b[..., 0] * cmask3


def contact_kkt_dynamics_partials_lane(m, q, v, tau, contact, bg_alpha,
                                       damping=1e-12):
    """Factored-KKT analytic derivative assembly (rbda.
    contact_kkt_dynamics_partials, WBM.cpp:459-505): 18 q-directions and
    18 v-directions through the KKT residual, then one multi-RHS
    application of the factored KKT matrix.

    Returns (dqdd_dq, dqdd_dv, dqdd_dtau, dlam_dq, dlam_dv, dlam_dtau),
    each [K, nd | 12, nd]."""
    cmask3, Sdiag = rbda._masks(contact, damping)
    Jw, Jv, Iw, Jm, h, gamma_m = _dyn_terms(m, q, v, cmask3, bg_alpha)
    M = rbda._mass_from_jacobians(m, Jw, Jv, Iw)
    sol, b = _kkt_schur_solve_lane(M, Jm, Sdiag, (tau - h)[..., None],
                                   -gamma_m[..., None])
    qdd, z_l = sol[..., 0], b[..., 0]

    def resid_q(q_):
        Jw_, Jv_, Iw_, Jm_, h_, g_ = _dyn_terms(m, q_, v, cmask3, bg_alpha)
        # M(q_) qdd contracted per body: the full M is never built under
        # the directions
        top = _per_body_mv(m, Jw_, Jv_, Iw_, qdd) + h_ + _mv(Jm_.mT, z_l)
        return torch.cat([top, _mv(Jm_, qdd) + g_], -1)     # [K, nd+12]

    def resid_v(v_):
        _, _, _, _, h_, g_ = _dyn_terms(m, q, v_, cmask3, bg_alpha)
        return torch.cat([h_, g_], -1)

    return _kkt_partials_tail(M, Jm, Sdiag, cmask3,
                              jac_lane(resid_q, q), jac_lane(resid_v, v))


def impulse_dynamics_lane(m, q, v, impact_mask, damping=1e-12):
    """Inelastic impact (rbda.impulse_dynamics / WBM.cpp:427-456):
    M(v+ - v) = Jm^T Lam, Jm v+ = 0, impact_mask [K, 4].  Returns
    (v_post [K, nd], impulse [K, 12])."""
    cmask3, Sdiag = rbda._masks(impact_mask, damping)
    Jw, Jv, Iw, J = _kin(m, q)
    v_post, b = _kkt_schur_solve_lane(
        rbda._mass_from_jacobians(m, Jw, Jv, Iw), J * cmask3[..., None],
        Sdiag, _per_body_mv(m, Jw, Jv, Iw, v)[..., None],
        torch.zeros_like(Sdiag)[..., None])
    return v_post[..., 0], -b[..., 0] * cmask3


def impulse_dynamics_partials_lane(m, q, v, impact_mask, damping=1e-12):
    """Analytic impulse partials (rbda.impulse_dynamics_partials /
    WBM.cpp:508-543): q-directions through the residual with per-body
    M-contractions, the v-columns one multi-RHS application of the
    factored KKT (rhs = M).  Returns (dvpost_dq, dvpost_dv), each
    [K, nd, nd]."""
    cmask3, Sdiag = rbda._masks(impact_mask, damping)
    Jw, Jv, Iw, J = _kin(m, q)
    M = rbda._mass_from_jacobians(m, Jw, Jv, Iw)
    Jm = J * cmask3[..., None]
    sol, b = _kkt_schur_solve_lane(M, Jm, Sdiag,
                                   _per_body_mv(m, Jw, Jv, Iw, v)[..., None],
                                   torch.zeros_like(Sdiag)[..., None])
    v_post, z_l = sol[..., 0], b[..., 0]
    dv = v_post - v

    def resid_q(q_):
        Jw_, Jv_, Iw_, J_ = _kin(m, q_)
        Jm_ = J_ * cmask3[..., None]
        top = _per_body_mv(m, Jw_, Jv_, Iw_, dv) + _mv(Jm_.mT, z_l)
        return torch.cat([top, _mv(Jm_, v_post)], -1)

    return rbda._impulse_partials_tail(M, Jm, Sdiag, jac_lane(resid_q, q))


# ------------------------------------------------------------------
# whole-body discrete-dynamics linearization (wbm layer)
# ------------------------------------------------------------------

def wb_dynamics_lane(m, x, u, dt, contact, bg_alpha):
    """Forward-Euler WB step: x [K, 36], u [K, 12], dt [K], contact [K, 4].
    Returns (xnext [K, 36], grf [K, 12]); mirrors wbm.dynamics
    (WBM.cpp:17-32)."""
    q, v = x[..., :NQ], x[..., NQ:]
    tau = wbm._tau_full(u)
    qdd, grf = contact_kkt_dynamics_lane(m, q, v, tau, contact, bg_alpha)
    dtc = dt[..., None]
    return torch.cat([q + v * dtc, v + qdd * dtc], -1), grf


def wb_dyn_partials_lane(m, x, u, dt, contact, bg_alpha):
    """A [K, 36, 36], B [K, 36, 12], C [K, 12, 36], D [K, 12, 12]:
    wbm.dynamics_partials_analytic over the knot batch."""
    q, v = x[..., :NQ], x[..., NQ:]
    tau = wbm._tau_full(u)
    return wbm._discrete_partials(dt, *contact_kkt_dynamics_partials_lane(
        m, q, v, tau, contact, bg_alpha))

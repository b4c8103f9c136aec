"""Knot-batched whole-body kinematics, dynamics and linearization (port of
`cafempc_tpu/models/wb_lane.py`).

The JAX module puts the flattened scenario x knot axis K last, for the
TPU's tiles.  Here K is the LEADING dimension, as everywhere in the port,
so the lane forms of FK, the mass matrix, gravity, the foot kinematics and
the Schur-complement KKT solve are `rbda`'s batched functions, and the
lane algebra (lanedot, lanemv, the unrolled lane Cholesky) is batched `@`,
`cholesky_ex` and `cholesky_solve`.  Shapes: q, v, tau [K, nd], x [K, 36],
u [K, 12], dt [K], contact [K, 4] (any leading dimensions work).

What is the lane module's own (WBM.cpp:459-505 structure):
  * the bias force as Jacobian-transpose Newton-Euler with qdd = 0, FIRST
    order in the FK derivatives;
  * M(q) x contracted per body (`Mv_lane`), so no derivative of M is ever
    built;
  * the factored-KKT derivative assembly: the KKT residual's 18 q- and 18
    v-directions, then one multi-RHS application of the factored KKT
    matrix.
The forward step takes its per-body Jacobians, world inertias and foot
Jacobians, and their time derivatives, from ONE FK pass and its jvp along v
(`_kin`): the JAX module leaves merging the repeated FK passes to XLA.

The port has one linearization: the residual's direction Jacobians come
from the closed-form FK derivative bundle (`cf_bundle`, ancestor
cross-product rules) and its one jvp along v, with no tangent through a
direction-vmapped FK.  The JAX module computes the same derivatives by jvp
directions by default (`jac_lane`) and by the bundle under its switch; the
tests hold the port to both.

Spans (`utils/tracing.py`, host only): `wb.partials` around
`contact_kkt_dynamics_partials_lane`, `wb.impulse_partials` around
`impulse_dynamics_partials_lane`, and inside both `wb.kin` (the bundle and
the KKT's primal pieces), `wb.kkt_solve` (`_kkt_schur_solve_lane`),
`wb.directions` (the bundle's residual tangents) and `wb.tail` (the
factored-KKT assembly); `wb.step` around the forward step,
`wb_dynamics_lane` and `impulse_dynamics_lane`.  The counter `wb.cf_knots`
adds the knots each call linearizes, `wb.step_knots` the knots each call
steps.
"""
import functools
import math
from typing import NamedTuple

import torch
from torch.func import jvp

from cafempc_tpu_torch.models import rbda, wbm
from cafempc_tpu_torch.models.rbda import _mv
from cafempc_tpu_torch.utils import tracing

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


# ------------------------------------------------------------------
# closed-form FK directional derivatives (ancestor cross-product rules)
# ------------------------------------------------------------------
#
# Every world-frame FK quantity has an exact first derivative in q:
#
#   d aw_i / dq_j  = anc(i,j) rev_j (aw_j x aw_i)
#   d pt   / dq_j  = anc(body(pt),j) [rev_j aw_j x (pt - p_j)
#                                     + (1-rev_j) aw_j]      (any point)
#   d Iw_b / dq_j  = anc(b,j) rev_j ([aw_j]x Iw_b - Iw_b [aw_j]x)
#   d Jcol(pt,l)/dq_j = anc(body(pt),l) { rev_l [ daw[j,l] x (pt - p_l)
#                         + aw_l x (dpt[j] - dp[j,l]) ]
#                         + (1-rev_l) daw[j,l] }             (product rule)
#
# They replace the 18-direction Jacobians of the KKT residual by masked
# cross products over (directions x bodies), and ALL time derivatives,
# the mixed ones d/dt(dJ/dq_j) of the bias-force tangents included, come
# from ONE jvp of the bundle along v (mixed partials commute).  Layout:
# the knot dims lead, then the direction axis j, e.g. dJv [..., 18, nb, 3,
# 18] (the JAX module puts the knot axis last).

def _count_cf_knots(q):
    """`wb.cf_knots` += the knots of q [..., nd]."""
    tracing.count("wb.cf_knots", math.prod(q.shape[:-1]))


def _count_step_knots(q):
    """`wb.step_knots` += the knots of q [..., nd]."""
    tracing.count("wb.step_knots", math.prod(q.shape[:-1]))


class _CFBundle(NamedTuple):
    """Primal FK quantities and their q-derivative stacks (j = the
    direction, l = a Jacobian's column)."""
    p: torch.Tensor        # [..., nd, 3] joint origins
    aw: torch.Tensor       # [..., nd, 3] world joint axes
    pts: torch.Tensor      # [..., nf, 3] foot points
    com: torch.Tensor      # [..., nb, 3]
    Iw: torch.Tensor       # [..., nb, 3, 3]
    Jw: torch.Tensor       # [..., nb, 3, nd]
    Jv: torch.Tensor       # [..., nb, 3, nd]
    J: torch.Tensor        # [..., nf, 3, nd] foot point Jacobians
    daw: torch.Tensor      # [..., j, nd, 3]
    dp: torch.Tensor       # [..., j, nd, 3]
    dpts: torch.Tensor     # [..., j, nf, 3]
    dcom: torch.Tensor     # [..., j, nb, 3]
    dIw: torch.Tensor      # [..., j, nb, 3, 3]
    dJw: torch.Tensor      # [..., j, nb, 3, nd]
    dJv: torch.Tensor      # [..., j, nb, 3, nd]
    dJ: torch.Tensor       # [..., j, nf, 3, nd]


# the ancestor masks of a model, made once from its `anc` and `rev` (the
# entry holds the model's `anc` tensor, so its id stays its own)
_CF_MASKS = {}


def _cf_masks(m):
    """Masks on the model's device and dtype: the ancestor rows of the
    joints (anc), feet (anc_f) and massy bodies (anc_b), each [np, nd],
    and the [j, i] masks of daw, of dIw (j, b) and of dJw (b, 1, l)."""
    hit = _CF_MASKS.get(id(m.anc))
    if hit is not None and hit[0] is m.anc:
        return hit[1]
    anc_b = m.anc[m.mb]
    masks = dict(
        anc=m.anc, anc_f=m.anc[m.fidx], anc_b=anc_b,
        daw=m.rev[:, None] * m.anc.T, dIw=m.rev[:, None] * anc_b.T,
        dJw=(anc_b * m.rev)[:, None, :])
    _CF_MASKS[id(m.anc)] = (m.anc, masks)
    return masks


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dpoint(m, aw, pts, p, anc_pts):
    """d pt / dq_j of points pts [..., np, 3] whose bodies have the
    ancestor rows anc_pts [np, nd]: [..., j, np, 3]."""
    d = pts[..., None, :, :] - p[..., :, None, :]           # [..., j, np, 3]
    rev = m.rev[:, None, None]
    out = rev * _cross(aw[..., :, None, :], d) \
        + (1.0 - rev) * aw[..., :, None, :]
    return out * anc_pts.T[..., None]


def _dpoint_jac(m, aw, daw, dp, pts, dpts, p, anc_pts):
    """d Jcol(pt, l) / dq_j [..., j, np, 3, l] by the product rule on the
    point-Jacobian formula."""
    daw_jl = daw[..., :, :, None, :]                        # [..., j,l,1,3]
    t1 = _cross(daw_jl, pts[..., None, None, :, :] - p[..., None, :, None, :])
    dd = dpts[..., :, None, :, :] - dp[..., :, :, None, :]  # [..., j,l,np,3]
    t2 = _cross(aw[..., None, :, None, :], dd)
    rev = m.rev[:, None, None]
    out = rev * (t1 + t2) + (1.0 - rev) * daw_jl
    return (out * anc_pts.T[..., None]).movedim(-3, -1)


def cf_bundle(m, q):
    """Primal FK and the closed-form first-derivative stacks at q
    [..., nd]."""
    mk = _cf_masks(m)
    R, p, aw = rbda.fk(m, q)
    pts = rbda._foot_points(m, R, p)
    com_w, Jw, Jv, Iw = rbda._body_jacobians(m, R, p, aw)
    J = rbda._point_jacobians_batch(m, p, aw, pts, m.fidx)
    daw = _cross(aw[..., :, None, :], aw[..., None, :, :]) \
        * mk["daw"][..., None]                               # [..., j, i, 3]
    dp = _dpoint(m, aw, p, p, mk["anc"])
    dpts = _dpoint(m, aw, pts, p, mk["anc_f"])
    dcom = _dpoint(m, aw, com_w, p, mk["anc_b"])
    # [a]x Iw - Iw [a]x = axI + axI^T with axI = [a]x Iw (Iw symmetric);
    # the cross of a with each column c of Iw is row c of axI^T
    axIT = _cross(aw[..., :, None, None, :], Iw.mT[..., None, :, :, :])
    dIw = (axIT.mT + axIT) * mk["dIw"][..., None, None]
    dJw = daw.mT[..., :, None, :, :] * mk["dJw"]
    dJv = _dpoint_jac(m, aw, daw, dp, com_w, dcom, p, mk["anc_b"])
    dJ = _dpoint_jac(m, aw, daw, dp, pts, dpts, p, mk["anc_f"])
    return _CFBundle(p, aw, pts, com_w, Iw, Jw, Jv, J,
                     daw, dp, dpts, dcom, dIw, dJw, dJv, dJ)


# --- bundle contractions (direction axis j after the knot dims) -----

def _dmv(dT, x):
    """[..., j, b, 3, nd] applied to x [..., nd] -> [..., j, b, 3]."""
    return _mv(dT, x[..., None, None, :])


def _dmtv_b(dT, y):
    """[..., j, b, 3, nd] transpose-applied to y [..., b, 3], summed over
    the bodies -> [..., j, nd]."""
    return _mv(dT.flatten(-3, -2).mT, y.flatten(-2)[..., None, :])


def _wtv(W, y):
    """[..., b, 3, nd] transpose-applied to y [..., j, b, 3], summed over
    the bodies -> [..., j, nd]."""
    return _mv(W.flatten(-3, -2).mT[..., None, :, :], y.flatten(-2))


def _mass_from_bundle(m, cf):
    """M(q) from the bundle, without another FK."""
    return rbda._mass_from_jacobians(m, cf.Jw, cf.Jv, cf.Iw)


def _mv_from_bundle(m, cf, v):
    """M(q) v per body from the bundle."""
    return _per_body_mv(m, cf.Jw, cf.Jv, cf.Iw, v)


def _cf_dMv(m, cf, u):
    """d/dq_j [M(q) u] for a constant u [..., nd], contracted per body on
    the bundle (dM/dq never exists): [..., j, nd]."""
    mw = m.mass[m.mb][:, None]
    u_j = u[..., None, :]
    wu = _mv(cf.Jw, u_j)
    return (_dmtv_b(cf.dJw, _mv(cf.Iw, wu))
            + _wtv(cf.Jw, _mv(cf.dIw, wu[..., None, :, :])
                   + _mv(cf.Iw[..., None, :, :, :], _dmv(cf.dJw, u)))
            + _dmtv_b(cf.dJv, mw * _mv(cf.Jv, u_j))
            + _wtv(cf.Jv, mw * _dmv(cf.dJv, u)))


def _cf_primal(m, cf, td, v, bg_alpha):
    """The KKT's primal pieces from the bundle and its v-jvp td: (M, h,
    J [..., 12, nd], Jdot [..., 12, nd], gamma_raw [..., 12]), h by the
    Newton-Euler form of `bias_force_lane`."""
    J, Jdot = cf.J.flatten(-3, -2), td.J.flatten(-3, -2)
    h = _newton_euler(m, (cf.Jw, cf.Jv, cf.Iw, J),
                      (td.Jw, td.Jv, td.Iw, Jdot), v)
    gamma_raw = _mv(Jdot, v) + 2.0 * bg_alpha * _mv(J, v)
    return _mass_from_bundle(m, cf), h, J, Jdot, gamma_raw


def _cf_tangents(m, cf, td, v, qdd, z_l, cmask3, bg_alpha):
    """Closed-form q- and v-Jacobians of the contact-KKT residual,
    (dG_dq, dG_dv) each [..., nd+12, nd] as `jac_lane` gives them, from the
    bundle cf and its v-jvp td."""
    mw = m.mass[m.mb][:, None]
    v_b = v[..., None, :]
    J, Jdot = cf.J.flatten(-3, -2), td.J.flatten(-3, -2)
    dJ, dJdot = cf.dJ.flatten(-3, -2), td.dJ.flatten(-3, -2)  # [..., j,12,nd]
    w_b = _mv(cf.Jw, v_b)
    wdot = _mv(td.Jw, v_b)
    a_b = _mv(td.Jv, v_b)
    dLdt = _mv(td.Iw, w_b) + _mv(cf.Iw, wdot)
    Iw_j, tdIw_j = cf.Iw[..., None, :, :, :], td.Iw[..., None, :, :, :]
    v_j = v[..., None, :]

    # q-directions: top = d[M qdd] + dh + dJm^T z, bottom = dJm qdd + dgamma
    dw = _dmv(cf.dJw, v)
    dh = (_dmtv_b(cf.dJw, dLdt)
          + _wtv(cf.Jw, _mv(td.dIw, w_b[..., None, :, :]) + _mv(tdIw_j, dw)
                 + _mv(cf.dIw, wdot[..., None, :, :])
                 + _mv(Iw_j, _dmv(td.dJw, v)))
          + _dmtv_b(cf.dJv, mw * a_b)
          + _wtv(cf.Jv, mw * _dmv(td.dJv, v))
          + rbda._gravity_from_jacobians(m, cf.dJv))
    dJm = dJ * cmask3[..., None, :, None]
    top_q = _cf_dMv(m, cf, qdd) + dh + _mv(dJm.mT, z_l[..., None, :])
    dgamma = (_mv(dJdot, v_j) + 2.0 * bg_alpha * _mv(dJ, v_j)) \
        * cmask3[..., None, :]
    bot_q = _mv(dJm, qdd[..., None, :]) + dgamma
    dG_dq = torch.cat([top_q, bot_q], -1).mT

    # v-directions: dh/dv_j = sum_b m_b Jv^T (dJv[j] v + Jvdot[:, :, j])
    #   + Jw^T (dIw[j] w_b + Iwdot Jw[:, :, j]
    #           + Iw (dJw[j] v + Jwdot[:, :, j]))
    inner = (_mv(cf.dIw, w_b[..., None, :, :])
             + _mv(tdIw_j, cf.Jw.movedim(-1, -3))
             + _mv(Iw_j, dw + td.Jw.movedim(-1, -3)))
    dh_dv = (_wtv(cf.Jw, inner)
             + _wtv(cf.Jv, mw * (_dmv(cf.dJv, v) + td.Jv.movedim(-1, -3))))
    dgamma_dv = (_mv(dJ, v_j) + Jdot.mT + 2.0 * bg_alpha * J.mT) \
        * cmask3[..., None, :]
    dG_dv = torch.cat([dh_dv, dgamma_dv], -1).mT
    return dG_dq, dG_dv


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
    contact_kkt_dynamics_partials, WBM.cpp:459-505): the KKT residual's 18
    q- and 18 v-directions from the closed-form bundle, then one multi-RHS
    application of the factored KKT matrix.

    Returns (dqdd_dq, dqdd_dv, dqdd_dtau, dlam_dq, dlam_dv, dlam_dtau),
    each [K, nd | 12, nd]."""
    with tracing.span("wb.partials"):
        cmask3, Sdiag = rbda._masks(contact, damping)
        _count_cf_knots(q)
        with tracing.span("wb.kin"):
            cf, td = jvp(functools.partial(cf_bundle, m), (q,), (v,))
            M, h, J, _, gamma_raw = _cf_primal(m, cf, td, v, bg_alpha)
            Jm = J * cmask3[..., None]
        with tracing.span("wb.kkt_solve"):
            sol, b = _kkt_schur_solve_lane(
                M, Jm, Sdiag, (tau - h)[..., None],
                -(gamma_raw * cmask3)[..., None])
        with tracing.span("wb.directions"):
            dG = _cf_tangents(m, cf, td, v, sol[..., 0], b[..., 0], cmask3,
                              bg_alpha)
        with tracing.span("wb.tail"):
            return _kkt_partials_tail(M, Jm, Sdiag, cmask3, *dG)


def impulse_dynamics_lane(m, q, v, impact_mask, damping=1e-12):
    """Inelastic impact (rbda.impulse_dynamics / WBM.cpp:427-456):
    M(v+ - v) = Jm^T Lam, Jm v+ = 0, impact_mask [K, 4].  Returns
    (v_post [K, nd], impulse [K, 12])."""
    with tracing.span("wb.step"):
        _count_step_knots(q)
        cmask3, Sdiag = rbda._masks(impact_mask, damping)
        Jw, Jv, Iw, J = _kin(m, q)
        v_post, b = _kkt_schur_solve_lane(
            rbda._mass_from_jacobians(m, Jw, Jv, Iw), J * cmask3[..., None],
            Sdiag, _per_body_mv(m, Jw, Jv, Iw, v)[..., None],
            torch.zeros_like(Sdiag)[..., None])
        return v_post[..., 0], -b[..., 0] * cmask3


def impulse_dynamics_partials_lane(m, q, v, impact_mask, damping=1e-12):
    """Analytic impulse partials (rbda.impulse_dynamics_partials /
    WBM.cpp:508-543): the residual's q-directions from the closed-form
    bundle with per-body M-contractions, the v-columns one multi-RHS
    application of the factored KKT (rhs = M).  Returns (dvpost_dq,
    dvpost_dv), each [K, nd, nd]."""
    with tracing.span("wb.impulse_partials"):
        cmask3, Sdiag = rbda._masks(impact_mask, damping)
        _count_cf_knots(q)
        with tracing.span("wb.kin"):
            cf = cf_bundle(m, q)
            M = _mass_from_bundle(m, cf)
            Jm = cf.J.flatten(-3, -2) * cmask3[..., None]
        with tracing.span("wb.kkt_solve"):
            sol, b = _kkt_schur_solve_lane(
                M, Jm, Sdiag, _mv_from_bundle(m, cf, v)[..., None],
                torch.zeros_like(Sdiag)[..., None])
        v_post, z_l = sol[..., 0], b[..., 0]
        with tracing.span("wb.directions"):
            dJm = cf.dJ.flatten(-3, -2) * cmask3[..., None, :, None]
            top = _cf_dMv(m, cf, v_post - v) + _mv(dJm.mT,
                                                    z_l[..., None, :])
            dG_dq = torch.cat([top, _mv(dJm, v_post[..., None, :])], -1).mT
        with tracing.span("wb.tail"):
            return rbda._impulse_partials_tail(M, Jm, Sdiag, dG_dq)


# ------------------------------------------------------------------
# whole-body discrete-dynamics linearization (wbm layer)
# ------------------------------------------------------------------

def wb_dynamics_lane(m, x, u, dt, contact, bg_alpha):
    """Forward-Euler WB step: x [K, 36], u [K, 12], dt [K], contact [K, 4].
    Returns (xnext [K, 36], grf [K, 12]); mirrors wbm.dynamics
    (WBM.cpp:17-32)."""
    with tracing.span("wb.step"):
        q, v = x[..., :NQ], x[..., NQ:]
        _count_step_knots(q)
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

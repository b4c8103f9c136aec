# Frozen copy of cafempc_tpu_torch/models/rbda.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Batched rigid-body dynamics for the whole-body model (port of
`cafempc_tpu/models/rbda.py`).

Replaces the reference's Pinocchio usage (crba / nonLinearEffects /
forwardDynamics / impulseDynamics / frame kinematics,
MHPC/MHPC-Trajopt/WBM.cpp:368-543) and its generated kinematics
derivatives with:

  * world-frame kinematics over an 18-dof single-dof-joint tree (the
    floating base is the PX,PY,PZ,RZ,RY,RX chain, PinocchioInteface.cpp),
  * the mass matrix from body Jacobians:  M = sum_b J_b^T I_b J_b,
  * bias forces via AD identities:  h = Mdot v - 0.5 d/dq (v^T M v) + g,
  * contact/impulse dynamics as masked fixed-size KKT solves (0..4 active
    feet without dynamically-sized systems),
  * derivatives by forward-mode AD (`torch.func`) through these functions.

Every function takes tensors with any leading batch dimensions: q, v, tau
[..., nd], contact [..., 4].  The samples are independent, so a jvp with a
tangent of the batch's shape is a per-sample directional derivative, and
`batched_jacobian` builds per-sample Jacobians from one jvp vmapped over
the directions.  The model is built at the solve's dtype and device; its
topology stays host-side Python.  Foot-frame order FL, FR, HL, HR
(WBM.h:21).
"""
from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from benchmark.reference.plain.models.urdf import REVOLUTE, TreeModel

GRAVITY = 9.81


class RBDAModel(NamedTuple):
    """Static-topology model: tensors on the solve's device and dtype; the
    topology (parent, jtype, frame_dof, has_mass, ancestors) stays Python
    and numpy, so its loops unroll on the host."""
    parent: tuple           # python ints
    jtype: tuple
    axis: torch.Tensor      # [nd, 3]
    R_tree: torch.Tensor    # [nd, 3, 3]
    p_tree: torch.Tensor    # [nd, 3]
    mass: torch.Tensor      # [nd]
    com: torch.Tensor       # [nd, 3]
    inertia: torch.Tensor   # [nd, 3, 3]
    frame_dof: tuple        # per end-effector frame: parent dof
    frame_R: torch.Tensor   # [nf, 3, 3]
    frame_p: torch.Tensor   # [nf, 3]
    has_mass: tuple         # python bools: body carries inertia/mass
    ancestors: np.ndarray   # [nd, nd] bool: ancestors[i, j] = dof j on
                            # the path from the root to body i (inclusive)
    # derived from the above, on the device:
    mb: torch.Tensor        # [nb] int64: the massy bodies
    fidx: torch.Tensor      # [nf] int64: frame_dof
    rev: torch.Tensor       # [nd] 1 for a revolute dof, 0 for prismatic
    anc: torch.Tensor       # [nd, nd] ancestors as 0 / 1
    skew: torch.Tensor      # [nd, 3, 3] the axis' cross-product matrix
    skew2: torch.Tensor     # [nd, 3, 3] its square

    @property
    def nd(self):
        return len(self.parent)


def make_model(parent, jtype, axis, R_tree, p_tree, mass, com, inertia,
               frame_dof, frame_R, frame_p, has_mass, device, dtype):
    """RBDAModel from host arrays (numpy) at `dtype` on `device`."""
    parent = tuple(int(p) for p in parent)
    nd = len(parent)
    anc = np.zeros((nd, nd), dtype=bool)
    for i in range(nd):
        j = i
        while j >= 0:
            anc[i, j] = True
            j = parent[j]
    axis = np.asarray(axis, np.float64)
    skew = np.zeros((nd, 3, 3))
    skew[:, 0, 1], skew[:, 0, 2] = -axis[:, 2], axis[:, 1]
    skew[:, 1, 0], skew[:, 1, 2] = axis[:, 2], -axis[:, 0]
    skew[:, 2, 0], skew[:, 2, 1] = -axis[:, 1], axis[:, 0]
    jtype = tuple(int(t) for t in jtype)
    has_mass = tuple(bool(h) for h in has_mass)
    frame_dof = tuple(int(f) for f in frame_dof)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    def idx(a):
        return torch.tensor(np.asarray(a, np.int64), device=device)

    return RBDAModel(
        parent=parent, jtype=jtype, axis=t(axis), R_tree=t(R_tree),
        p_tree=t(p_tree), mass=t(mass), com=t(com), inertia=t(inertia),
        frame_dof=frame_dof, frame_R=t(frame_R), frame_p=t(frame_p),
        has_mass=has_mass, ancestors=anc,
        mb=idx([b for b in range(nd) if has_mass[b]]), fidx=idx(frame_dof),
        rev=t([1.0 if k == REVOLUTE else 0.0 for k in jtype]), anc=t(anc),
        skew=t(skew), skew2=t(skew @ skew))


def build_model(tree: TreeModel, device="cuda",
                dtype=torch.float32) -> RBDAModel:
    """The model of a parsed URDF tree at the solve's dtype and device."""
    return make_model(
        tree.parent, tree.jtype, tree.axis, tree.R_tree, tree.p_tree,
        tree.mass, tree.com, tree.inertia, [f[1] for f in tree.frames],
        np.stack([f[2] for f in tree.frames]),
        np.stack([f[3] for f in tree.frames]),
        [m > 0 or np.any(I) for m, I in zip(tree.mass, tree.inertia)],
        device, dtype)


def batched_jacobian(f, x):
    """Per-sample forward-mode Jacobian: f maps x [..., n] to a tensor
    [..., *out] (or a tuple of them) whose samples depend only on their own
    input; returns [..., *out, n].  One jvp vmapped over the n directions
    of the basis, each broadcast over the batch."""
    basis = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)

    def one(e):
        return jvp(f, (x,), (e.expand_as(x),))[1]

    out = vmap(one)(basis)
    if isinstance(out, tuple):
        return tuple(o.movedim(0, -1) for o in out)
    return out.movedim(0, -1)


def _mv(A, x):
    """[..., a, b] @ [..., b] -> [..., a]."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def fk(model: RBDAModel, q):
    """Forward kinematics: q [..., nd] -> (R [..., nd, 3, 3] body->world
    rotations, p [..., nd, 3] world origins, a_w [..., nd, 3] world joint
    axes)."""
    batch = q.shape[:-1]
    c, s = torch.cos(q), torch.sin(q)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    Rs, ps, aw = [], [], []
    for i in range(model.nd):
        pi = model.parent[i]
        if pi >= 0:
            Rp = Rs[pi]
            R_pre = Rp @ model.R_tree[i]
            p_i = ps[pi] + _mv(Rp, model.p_tree[i])
        else:
            R_pre = model.R_tree[i].expand(*batch, 3, 3)
            p_i = model.p_tree[i].expand(*batch, 3)
        a_i = _mv(R_pre, model.axis[i])
        if model.jtype[i] == REVOLUTE:
            rot = (eye + s[..., i, None, None] * model.skew[i]
                   + (1 - c[..., i, None, None]) * model.skew2[i])
            R_i = R_pre @ rot
        else:
            R_i = R_pre
            p_i = p_i + a_i * q[..., i, None]
        Rs.append(R_i)
        ps.append(p_i)
        aw.append(a_i)
    return torch.stack(Rs, -3), torch.stack(ps, -2), torch.stack(aw, -2)


def point_jacobian(model, R, p, aw, dof, point_w):
    """[Jw; Jv] (each [..., 3, nd]) of a point point_w [..., 3] attached to
    body `dof` (a python int), world-aligned."""
    anc = model.anc[dof]                                     # [nd]
    Jw = (model.rev[:, None] * aw * anc[:, None]).mT
    cr = torch.linalg.cross(aw, point_w[..., None, :] - p, dim=-1)
    Jv = ((model.rev[:, None] * cr + (1 - model.rev[:, None]) * aw)
          * anc[:, None]).mT
    return Jw, Jv


def _point_jacobians_batch(model, p, aw, points_w, dofs):
    """Linear world Jacobians of several points at once: points_w
    [..., np, 3] attached to bodies `dofs` (int64 tensor [np]).  Returns
    Jv [..., np, 3, nd]."""
    anc = model.anc[dofs]                                     # [np, nd]
    d = points_w[..., :, None, :] - p[..., None, :, :]        # [..., np,nd,3]
    cr = torch.linalg.cross(aw[..., None, :, :], d, dim=-1)
    rev = model.rev[:, None]
    cols = rev * cr + (1 - rev) * aw[..., None, :, :]
    return (cols * anc[..., None]).mT                         # [..., np,3,nd]


def _body_jacobians(model, R, p, aw):
    """CoM world positions, Jacobians and world inertias of every massy
    body at once.  Returns (com_w [..., nb, 3], Jw [..., nb, 3, nd],
    Jv [..., nb, 3, nd], Iw [..., nb, 3, 3])."""
    mb = model.mb
    Rb = R[..., mb, :, :]
    com_w = p[..., mb, :] + _mv(Rb, model.com[mb])
    Jv = _point_jacobians_batch(model, p, aw, com_w, mb)
    Jw = ((model.rev[:, None] * aw)[..., None, :, :]
          * model.anc[mb][..., None]).mT                      # [..., nb,3,nd]
    Iw = Rb @ model.inertia[mb] @ Rb.mT
    return com_w, Jw, Jv, Iw


def _mass_from_jacobians(model, Jw, Jv, Iw):
    """M = sum_b Jw^T Iw Jw + m Jv^T Jv, the body and row axes contracted
    in one product each."""
    m = model.mass[model.mb][:, None, None]
    Jw_f, Jv_f = Jw.flatten(-3, -2), Jv.flatten(-3, -2)      # [..., 3nb, nd]
    return (Jw_f.mT @ (Iw @ Jw).flatten(-3, -2)
            + Jv_f.mT @ (m * Jv).flatten(-3, -2))


def _gravity_from_jacobians(model, Jv):
    """g(q) = -sum_b m_b Jv_b^T [0, 0, -GRAVITY]."""
    return GRAVITY * (model.mass[model.mb][:, None] * Jv[..., 2, :]).sum(-2)


def mass_matrix(model: RBDAModel, q):
    """M(q) [..., nd, nd]."""
    _, Jw, Jv, Iw = _body_jacobians(model, *fk(model, q))
    return _mass_from_jacobians(model, Jw, Jv, Iw)


def gravity_force(model: RBDAModel, q):
    """g(q) [..., nd]: generalized gravity (enters M qdd + C v + g = tau)."""
    _, _, Jv, _ = _body_jacobians(model, *fk(model, q))
    return _gravity_from_jacobians(model, Jv)


def bias_force(model: RBDAModel, q, v):
    """h(q,v) = C(q,v) v + g(q), via the AD identity
    C v = Mdot v - 0.5 * d/dq (v^T M v); the gradient of the batch's sum
    is the per-sample gradient."""
    Mdot = jvp(lambda q_: mass_matrix(model, q_), (q,), (v,))[1]
    dKE = grad(lambda q_: 0.5 * (v * _mv(mass_matrix(model, q_), v)).sum())(q)
    return _mv(Mdot, v) - dKE + gravity_force(model, q)


def _foot_points(model, R, p):
    """World origins of the end-effector frames [..., nf, 3]."""
    fidx = model.fidx
    return p[..., fidx, :] + _mv(R[..., fidx, :, :], model.frame_p)


def foot_kinematics(model: RBDAModel, q):
    """World positions of the end-effector frames [..., nf, 3]."""
    R, p, _ = fk(model, q)
    return _foot_points(model, R, p)


def foot_jacobians(model: RBDAModel, q):
    """Linear world-aligned Jacobians of the end-effector frames
    [..., nf, 3, nd] (the reference's get_footJacobians, WBM.cpp:349-364)."""
    R, p, aw = fk(model, q)
    return _point_jacobians_batch(model, p, aw, _foot_points(model, R, p),
                                  model.fidx)


def foot_kinematics_and_jacobians(model: RBDAModel, q):
    """(foot_kinematics, foot_jacobians) from one forward kinematics."""
    R, p, aw = fk(model, q)
    pf = _foot_points(model, R, p)
    return pf, _point_jacobians_batch(model, p, aw, pf, model.fidx)


def foot_velocities(model: RBDAModel, q, v):
    """[..., nf, 3] world foot velocities (WBM.cpp:309-320)."""
    return _mv(foot_jacobians(model, q), v[..., None, :])


def foot_vel_dq(model: RBDAModel, q, v):
    """d(foot velocity)/dq [..., nf, 3, nd] (the reference's generated
    footVelPartialDq kernel, WBM.cpp:565-585)."""
    return batched_jacobian(lambda q_: foot_velocities(model, q_, v), q)


def foot_drift(model: RBDAModel, q, v):
    """Classical foot acceleration with qdd = 0: Jdot(q, v) v [..., nf, 3]."""
    return jvp(lambda q_: foot_velocities(model, q_, v), (q,), (v,))[1]


def _kkt_schur_solve(M, Jm, Sdiag, r1, r2):
    """Solve the contact KKT system

        [ M    Jm^T ] [ a ]   [ r1 ]
        [ Jm   -S   ] [ b ] = [ r2 ]

    via the Schur complement on the SPD mass matrix (two Cholesky
    factorizations, nd and 12): M [..., nd, nd], Jm [..., 12, nd], Sdiag
    [..., 12], right-hand sides r1 [..., nd, k], r2 [..., 12, k].  Returns
    (a [..., nd, k], b [..., 12, k]).  `cholesky_ex` leaves a failed
    factorization to show as non-finite values, with no host sync."""
    Lm = torch.linalg.cholesky_ex(M).L
    MinvJT = torch.cholesky_solve(Jm.mT, Lm)                 # [..., nd, 12]
    Minv_r1 = torch.cholesky_solve(r1, Lm)
    A_s = Jm @ MinvJT + torch.diag_embed(Sdiag)              # [..., 12, 12]
    Ls = torch.linalg.cholesky_ex(A_s).L
    b = torch.cholesky_solve(Jm @ Minv_r1 - r2, Ls)
    a = Minv_r1 - MinvJT @ b
    return a, b


def _masks(contact, damping):
    """(cmask3 [..., 12], Sdiag [..., 12]) of a contact mask [..., 4]."""
    cmask3 = contact.repeat_interleave(3, dim=-1)
    return cmask3, (1.0 - cmask3) + damping * cmask3


def contact_kkt_dynamics(model: RBDAModel, q, v, tau, contact, bg_alpha,
                         damping=1e-12):
    """Contact-constrained forward dynamics with Baumgarte velocity
    stabilization (WBM.cpp:368-424), masked fixed-size KKT:

        [ M    Jm^T ] [ qdd  ]   [ tau - h  ]
        [ Jm   -S   ] [ -lam ] = [ -gamma_m ]

    with Jm = contact-masked stacked foot Jacobians (12 x nd), S =
    diag(1-mask) + damping*mask, gamma = Jdot v + 2*bg_alpha*v_foot.
    Returns (qdd [..., nd], GRF [..., 12]).
    """
    cmask3, Sdiag = _masks(contact, damping)
    M = mass_matrix(model, q)
    h = bias_force(model, q, v)
    J = foot_jacobians(model, q).flatten(-3, -2)
    Jm = J * cmask3[..., None]
    gamma_m = (foot_drift(model, q, v).flatten(-2)
               + 2.0 * bg_alpha * _mv(J, v)) * cmask3
    qdd, b = _kkt_schur_solve(M, Jm, Sdiag, (tau - h)[..., None],
                              -gamma_m[..., None])
    return qdd[..., 0], -b[..., 0] * cmask3


def _kkt_partials_tail(M, Jm, Sdiag, cmask3, dG_dq, dG_dv):
    """One multi-RHS application of the factored KKT matrix to the columns
    [q-dirs | v-dirs | tau-dirs]: dG_dq, dG_dv [..., nd+12, nd] are the
    residual's Jacobians.  Returns (dqdd_dq, dqdd_dv, dqdd_dtau, dlam_dq,
    dlam_dv, dlam_dtau)."""
    nd = M.shape[-1]
    eye = torch.eye(nd, dtype=M.dtype, device=M.device).expand_as(M)
    R1 = torch.cat([-dG_dq[..., :nd, :], -dG_dv[..., :nd, :], eye], -1)
    R2 = torch.cat([-dG_dq[..., nd:, :], -dG_dv[..., nd:, :],
                    torch.zeros_like(Jm)], -1)
    dqdd, db = _kkt_schur_solve(M, Jm, Sdiag, R1, R2)
    dlam = -db * cmask3[..., None]
    return (dqdd[..., :nd], dqdd[..., nd:2 * nd], dqdd[..., 2 * nd:],
            dlam[..., :nd], dlam[..., nd:2 * nd], dlam[..., 2 * nd:])


def _impulse_partials_tail(M, Jm, Sdiag, dG_dq):
    """The impulse's q- and v-columns in one multi-RHS application of the
    factored KKT matrix to [-dG_dq | M]: dG_dq [..., nd+12, nd] is the
    impulse residual's q-Jacobian.  Returns (dvpost_dq, dvpost_dv)."""
    nd = M.shape[-1]
    R1 = torch.cat([-dG_dq[..., :nd, :], M], -1)
    R2 = torch.cat([-dG_dq[..., nd:, :], torch.zeros_like(Jm)], -1)
    dvp, _ = _kkt_schur_solve(M, Jm, Sdiag, R1, R2)
    return dvp[..., :nd], dvp[..., nd:]


def contact_kkt_dynamics_partials(model: RBDAModel, q, v, tau, contact,
                                  bg_alpha, damping=1e-12):
    """Analytic derivative assembly for `contact_kkt_dynamics` (the
    reference's KKT-matrix-inverse trick, WBM.cpp:459-505):

        K z = rhs,   dz = K^{-1} (drhs - dK z)

    so every derivative column is one application of the factored KKT
    matrix to an assembled right-hand side:
      * d/dtau:  [I; 0]
      * d/dv:    [-dh/dv; -dgamma_m/dv]     (18 v-directions)
      * d/dq:    -d/dq [M qdd + h - Jm^T lam; Jm qdd + gamma_m]
    No tangent propagates through the linear solve.

    Returns (dqdd_dq, dqdd_dv, dqdd_dtau, dlam_dq, dlam_dv, dlam_dtau),
    each [..., nd | 12, nd].
    """
    cmask3, Sdiag = _masks(contact, damping)
    M = mass_matrix(model, q)
    h = bias_force(model, q, v)
    J = foot_jacobians(model, q).flatten(-3, -2)
    Jm = J * cmask3[..., None]
    gamma_m = (foot_drift(model, q, v).flatten(-2)
               + 2.0 * bg_alpha * _mv(J, v)) * cmask3
    sol, b = _kkt_schur_solve(M, Jm, Sdiag, (tau - h)[..., None],
                              -gamma_m[..., None])
    qdd, z_l = sol[..., 0], b[..., 0]                        # z_l = -lam

    def resid_q(q_):
        J_ = foot_jacobians(model, q_).flatten(-3, -2)
        Jm_ = J_ * cmask3[..., None]
        g_ = (foot_drift(model, q_, v).flatten(-2)
              + 2.0 * bg_alpha * _mv(J_, v)) * cmask3
        top = (_mv(mass_matrix(model, q_), qdd) + bias_force(model, q_, v)
               + _mv(Jm_.mT, z_l))
        return torch.cat([top, _mv(Jm_, qdd) + g_], -1)

    def resid_v(v_):
        g_ = (foot_drift(model, q, v_).flatten(-2)
              + 2.0 * bg_alpha * _mv(J, v_)) * cmask3
        return torch.cat([bias_force(model, q, v_), g_], -1)

    return _kkt_partials_tail(M, Jm, Sdiag, cmask3,
                           batched_jacobian(resid_q, q),
                           batched_jacobian(resid_v, v))


def impulse_dynamics(model: RBDAModel, q, v, contact, damping=1e-12):
    """Inelastic impact (restitution 0): M(v+ - v) = J^T Lam, Jm v+ = 0
    (WBM.cpp:427-456 / pinocchio impulseDynamics).  Returns (v_post
    [..., nd], impulse [..., 12])."""
    cmask3, Sdiag = _masks(contact, damping)
    M = mass_matrix(model, q)
    Jm = foot_jacobians(model, q).flatten(-3, -2) * cmask3[..., None]
    v_post, b = _kkt_schur_solve(M, Jm, Sdiag, _mv(M, v)[..., None],
                                 torch.zeros_like(Sdiag)[..., None])
    return v_post[..., 0], -b[..., 0] * cmask3


def impulse_dynamics_partials(model: RBDAModel, q, v, contact,
                              damping=1e-12):
    """Analytic partials of `impulse_dynamics` (WBM.cpp:508-543,
    KKTImpactDerivatives): the same factored-KKT reuse as the contact
    dynamics.  Returns (dvpost_dq, dvpost_dv), each [..., nd, nd]."""
    cmask3, Sdiag = _masks(contact, damping)
    M = mass_matrix(model, q)
    Jm = foot_jacobians(model, q).flatten(-3, -2) * cmask3[..., None]
    sol, b = _kkt_schur_solve(M, Jm, Sdiag, _mv(M, v)[..., None],
                              torch.zeros_like(Sdiag)[..., None])
    v_post, z_l = sol[..., 0], b[..., 0]

    def resid_q(q_):
        Jm_ = foot_jacobians(model, q_).flatten(-3, -2) * cmask3[..., None]
        top = _mv(mass_matrix(model, q_), v_post - v) + _mv(Jm_.mT, z_l)
        return torch.cat([top, _mv(Jm_, v_post)], -1)

    return _impulse_partials_tail(M, Jm, Sdiag, batched_jacobian(resid_q, q))


def com_position(model: RBDAModel, q):
    """Whole-body CoM [..., 3]."""
    R, p, aw = fk(model, q)
    com_w = _body_jacobians(model, R, p, aw)[0]
    m = model.mass[model.mb]
    return (m[:, None] * com_w).sum(-2) / m.sum()


def centroidal_angular_momentum(model: RBDAModel, q, v):
    """k_G [..., 3]: angular momentum about the CoM (reference
    evalute_centroidal_momemtum, WBM.cpp:142-150)."""
    com_w, Jw, Jv, Iw = _body_jacobians(model, *fk(model, q))
    m = model.mass[model.mb][:, None]
    com = (m * com_w).sum(-2) / m.sum()
    w_b = _mv(Jw, v[..., None, :])
    v_b = _mv(Jv, v[..., None, :])
    return (_mv(Iw, w_b).sum(-2)
            + (m * torch.linalg.cross(com_w - com[..., None, :], v_b,
                                      dim=-1)).sum(-2))

"""Hybrid-kinodynamic (HKD) quadruped model in closed form, batched over
leading dimensions (port of `cafempc_tpu/models/hkd.py`).

State (24):   [eul(3: yaw,pitch,roll), pos(3), omega_body(3), vWorld(3),
               qdummy(12)]
Control (24): [GRF_world(12), commanded joint velocities(12)]

Per-leg ``qdummy``: joint angles (abad, hip, knee) while the leg swings;
world-frame foot position while it stances.  Leg order is the
Cheetah-Software convention FR, FL, HR, HL.

Every function takes tensors with any leading dimensions (scenarios,
knots) that broadcast against each other: x [..., 24], u [..., 24],
dt [...], contact [..., 4].  Constants are plain Python numbers and are
materialized at the input's dtype and device, so the f32 path builds no
f64 temporaries.
"""
import torch
from torch.func import jacfwd, vmap

from cafempc_tpu_torch.utils.rotations import (
    eul_to_rot, omega_to_euldrate_mat, rotx, roty, rotz, skew)

XS = 24
US = 24
YS = 0

MASS = 8.912
INERTIA_DIAG = (0.02746078, 0.2425157968, 0.2651935768)
GRAVITY = 9.81

# Leg geometry (Cheetah-Software convention; FR, FL, HR, HL)
HIP_X = (0.19, 0.19, -0.19, -0.19)
HIP_Y = (-0.049, 0.049, -0.049, 0.049)
SIDE_SIGN = (-1.0, 1.0, -1.0, 1.0)
L1 = 0.062   # abad link
L2 = 0.209   # thigh
L3 = 0.195   # shank
QLEG_DEFAULT = (0.0, -0.8, 1.7)  # HKDReset.h:37


def _const(vals, like):
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


def _legs_fk_local(qd4):
    """Foot position in the body frame for all 4 legs:
    qd4 [..., 4, 3] -> [..., 4, 3]."""
    s1, c1 = torch.sin(qd4[..., 0]), torch.cos(qd4[..., 0])
    s2, c2 = torch.sin(qd4[..., 1]), torch.cos(qd4[..., 1])
    s3, c3 = torch.sin(qd4[..., 2]), torch.cos(qd4[..., 2])
    s23 = s2 * c3 + c2 * s3
    c23 = c2 * c3 - s2 * s3
    sig = _const(SIDE_SIGN, qd4)
    ext = L3 * c23 + L2 * c2           # leg extension along -z of abad frame
    px = _const(HIP_X, qd4) + L3 * s23 + L2 * s2
    py = _const(HIP_Y, qd4) + sig * L1 * c1 + s1 * ext
    pz = sig * L1 * s1 - c1 * ext
    return torch.stack([px, py, pz], dim=-1)


def _legs_jacobian_local(qd4):
    """Analytic Jacobian of `_legs_fk_local` wrt each leg's joint angles:
    qd4 [..., 4, 3] -> [..., 4, 3, 3]."""
    s1, c1 = torch.sin(qd4[..., 0]), torch.cos(qd4[..., 0])
    s2, c2 = torch.sin(qd4[..., 1]), torch.cos(qd4[..., 1])
    s3, c3 = torch.sin(qd4[..., 2]), torch.cos(qd4[..., 2])
    s23 = s2 * c3 + c2 * s3
    c23 = c2 * c3 - s2 * s3
    sig = _const(SIDE_SIGN, qd4)
    ext = L3 * c23 + L2 * c2
    dext2 = -L3 * s23 - L2 * s2
    dext3 = -L3 * s23
    z = torch.zeros_like(s1)
    row_x = torch.stack([z, ext, L3 * c23], dim=-1)
    row_y = torch.stack([-sig * L1 * s1 + c1 * ext, s1 * dext2, s1 * dext3],
                        dim=-1)
    row_z = torch.stack([sig * L1 * c1 + s1 * ext, -c1 * dext2, -c1 * dext3],
                        dim=-1)
    return torch.stack([row_x, row_y, row_z], dim=-2)


def _rot_derivs(eul):
    """R(eul) and its partials wrt (yaw, pitch, roll) for the ZYX chain."""
    Rz, Ry, Rx = rotz(eul[..., 0]), roty(eul[..., 1]), rotx(eul[..., 2])
    R = Rz @ Ry @ Rx
    ez = skew(_const((0.0, 0.0, 1.0), eul))
    ey = skew(_const((0.0, 1.0, 0.0), eul))
    ex = skew(_const((1.0, 0.0, 0.0), eul))
    return R, ez @ R, Rz @ ey @ Ry @ Rx, Rz @ Ry @ ex @ Rx


def _as_four(qleg):
    """One leg's angles [..., 3] in every leg's slot: [..., 4, 3]."""
    return qleg.unsqueeze(-2).expand(*qleg.shape[:-1], 4, 3)


def leg_fk_local(qleg, leg):
    """Foot position in the body frame of one leg: qleg [..., 3]
    [abad, hip, knee] -> [..., 3]; leg a static int 0..3."""
    return _legs_fk_local(_as_four(qleg))[..., leg, :]


def leg_jacobian_local(qleg, leg):
    """Analytic 3x3 Jacobian of `leg_fk_local` wrt the leg's joint angles:
    [..., 3, 3]."""
    return _legs_jacobian_local(_as_four(qleg))[..., leg, :, :]


def foot_position(pos, eul, qleg, leg):
    """World-frame foot position of one leg (reference
    `compute_foot_position`): pos/eul/qleg [..., 3], leg a static int."""
    p_l = leg_fk_local(qleg, leg)
    return pos + (eul_to_rot(eul) @ p_l.unsqueeze(-1)).squeeze(-1)


def foot_world_jacobians(pos, eul, qleg, leg):
    """Analytic partials of the world-frame foot position: (J_eul
    [..., 3, 3], J_q [..., 3, 3]); d/dpos is the identity."""
    R, dR_dy, dR_dp, dR_dr = _rot_derivs(eul)
    p_l = leg_fk_local(qleg, leg).unsqueeze(-1)
    J_eul = torch.cat([dR_dy @ p_l, dR_dp @ p_l, dR_dr @ p_l], dim=-1)
    return J_eul, R @ leg_jacobian_local(qleg, leg)


def foot_jacobian(pos, eul, qleg, leg):
    """d foot_position / d (pos(3), eul(3), qdummy(12)): [..., 3, 18] with
    the column layout [d/dpos, d/deul, d/dqdummy] of the reference's
    `comp_foot_jacob_*` (HKDReset.h:131-133); the qdummy columns are
    zero outside the leg's own three."""
    J_eul, J_q = foot_world_jacobians(pos, eul, qleg, leg)
    shape = torch.broadcast_shapes(pos.shape[:-1], J_eul.shape[:-2])
    I3 = torch.eye(3, dtype=J_q.dtype, device=J_q.device)
    J_q = J_q.expand(shape + (3, 3))
    return torch.cat([I3.expand(shape + (3, 3)), J_eul.expand(shape + (3, 3)),
                      J_q.new_zeros(shape + (3, 3 * leg)), J_q,
                      J_q.new_zeros(shape + (3, 9 - 3 * leg))], dim=-1)


def _feet_world(pos, eul, qd4):
    """World foot positions of all legs from joint angles: [..., 4, 3]."""
    R = eul_to_rot(eul)
    p_l = _legs_fk_local(qd4)
    return pos.unsqueeze(-2) + torch.einsum("...ij,...lj->...li", R, p_l)


def dynamics_continuous(x, u, contact):
    """Continuous-time HKD dynamics xdot = f(x, u; contact)."""
    eul, pos = x[..., 0:3], x[..., 3:6]
    omega, vel = x[..., 6:9], x[..., 9:12]
    p_feet = x[..., 12:24].unflatten(-1, (4, 3))
    grf, qJd_cmd = u[..., 0:12], u[..., 12:24]
    inertia = _const(INERTIA_DIAG, x)

    R = eul_to_rot(eul)
    f = grf.unflatten(-1, (4, 3)) * contact.unsqueeze(-1)
    f_tot = f.sum(dim=-2)
    # torque arm with the foot height zeroed (feet on the ground plane),
    # as the reference kernel computes it
    p_arm = p_feet * _const((1.0, 1.0, 0.0), x)
    tau_w = torch.linalg.cross(p_arm - pos.unsqueeze(-2), f).sum(dim=-2)
    tau_b = (R.transpose(-1, -2) @ tau_w.unsqueeze(-1)).squeeze(-1)
    omega_dot = (tau_b - torch.linalg.cross(omega, inertia * omega)) \
        / inertia
    v_dot = f_tot / MASS + _const((0.0, 0.0, -GRAVITY), x)
    euld = (omega_to_euldrate_mat(eul) @ omega.unsqueeze(-1)).squeeze(-1)
    # qdummy rate: commanded joint velocity when swinging, frozen in stance
    qdummy_dot = qJd_cmd * (1.0 - contact.repeat_interleave(3, dim=-1))
    return torch.cat([euld, vel, omega_dot, v_dot, qdummy_dot], dim=-1)


def dynamics(x, u, dt, contact):
    """Discrete forward-Euler step (reference `hkinodyn`)."""
    return x + dt.unsqueeze(-1) * dynamics_continuous(x, u, contact)


def dynamics_partials(x, u, dt, contact):
    """A = dxnext/dx, B = dxnext/du in closed form (reference
    `hkinodyn_par`), assembled from analytic blocks: [..., 24, 24] each."""
    eul, pos, omega = x[..., 0:3], x[..., 3:6], x[..., 6:9]
    p_feet = x[..., 12:24].unflatten(-1, (4, 3))
    f = u[..., 0:12].unflatten(-1, (4, 3)) * contact.unsqueeze(-1)
    inertia = _const(INERTIA_DIAG, x)
    Iinv = 1.0 / inertia
    shape = x.shape[:-1]

    sp, cp = torch.sin(eul[..., 1]), torch.cos(eul[..., 1])
    sr, cr = torch.sin(eul[..., 2]), torch.cos(eul[..., 2])
    cp2 = cp * cp
    z = torch.zeros_like(sp)

    # --- euld = W(eul) @ omega
    W = omega_to_euldrate_mat(eul)
    dW_dp = torch.stack([
        torch.stack([z, sr * sp / cp2, cr * sp / cp2], -1),
        torch.stack([z, z, z], -1),
        torch.stack([z, sr / cp2, cr / cp2], -1)], -2)
    dW_dr = torch.stack([
        torch.stack([z, cr / cp, -sr / cp], -1),
        torch.stack([z, -sr, -cr], -1),
        torch.stack([z, sp * cr / cp, -sp * sr / cp], -1)], -2)
    om = omega.unsqueeze(-1)
    deuld_deul = torch.cat([torch.zeros_like(om), dW_dp @ om, dW_dr @ om],
                           dim=-1)

    # --- omega_dot = Iinv (R^T tau_w - omega x (I omega))
    R, dR_dy, dR_dp, dR_dr = _rot_derivs(eul)
    RT = R.transpose(-1, -2)
    arms = p_feet * _const((1.0, 1.0, 0.0), x) - pos.unsqueeze(-2)
    tau_w = torch.linalg.cross(arms, f).sum(dim=-2).unsqueeze(-1)
    dwd_deul = Iinv.unsqueeze(-1) * torch.cat(
        [d.transpose(-1, -2) @ tau_w for d in (dR_dy, dR_dp, dR_dr)], dim=-1)
    dwd_dpos = Iinv.unsqueeze(-1) * (RT @ skew(f.sum(dim=-2)))
    dwd_domega = Iinv.unsqueeze(-1) * (skew(inertia * omega)
                                       - skew(omega) * inertia)
    # per-leg qdummy block: Iinv RT (-skew(f_l)) diag(1,1,0)
    dwd_dqd = -torch.einsum("...ij,...ljk->...ilk", RT, skew(f)) \
        * _const((1.0, 1.0, 0.0), x)
    dwd_dqd = (Iinv[:, None, None] * dwd_dqd).flatten(-2)
    # per-leg grf block: Iinv RT skew(arm_l) * contact_l
    dwd_dgrf = torch.einsum("...ij,...ljk->...ilk", RT, skew(arms)) \
        * contact.unsqueeze(-2).unsqueeze(-1)
    dwd_dgrf = (Iinv[:, None, None] * dwd_dgrf).flatten(-2)

    def zeros(r, c):
        return x.new_zeros(shape + (r, c))

    I3 = torch.eye(3, dtype=x.dtype, device=x.device).expand(shape + (3, 3))
    Z33 = zeros(3, 3)
    Z3_12 = zeros(3, 12)
    Fx = torch.cat([
        torch.cat([deuld_deul, Z33, W, Z33, Z3_12], dim=-1),
        torch.cat([Z33, Z33, Z33, I3, Z3_12], dim=-1),
        torch.cat([dwd_deul, dwd_dpos, dwd_domega, Z33, dwd_dqd], dim=-1),
        zeros(15, 24)], dim=-2)

    c3 = contact.repeat_interleave(3, dim=-1)
    u_vel = (c3.unsqueeze(-2) / MASS
             * torch.eye(3, dtype=x.dtype, device=x.device).repeat(1, 4))
    u_qd = torch.diag_embed(1.0 - c3)
    Fu = torch.cat([
        zeros(6, 24),
        torch.cat([dwd_dgrf, zeros(3, 12)], dim=-1),
        torch.cat([u_vel.expand(shape + (3, 12)), zeros(3, 12)], dim=-1),
        torch.cat([zeros(12, 12), u_qd.expand(shape + (12, 12))], dim=-1)],
        dim=-2)

    dtm = dt.unsqueeze(-1).unsqueeze(-1)
    A = torch.eye(24, dtype=x.dtype, device=x.device) + dtm * Fx
    return A, dtm * Fu


def _sample_jacfwd(fn, argnums, args, trail):
    """jacfwd of the one-sample function fn wrt `argnums`, vmapped over the
    inputs' broadcast leading dimensions, flattened into one; trail[i] is
    the number of trailing dimensions of one sample of args[i]."""
    shape = torch.broadcast_shapes(*(a.shape[:a.dim() - t]
                                     for a, t in zip(args, trail)))
    flat = [a.expand(shape + a.shape[a.dim() - t:])
            .reshape((-1,) + a.shape[a.dim() - t:])
            for a, t in zip(args, trail)]
    out = vmap(jacfwd(fn, argnums=argnums))(*flat)
    if isinstance(out, tuple):
        return tuple(o.reshape(shape + o.shape[1:]) for o in out)
    return out.reshape(shape + out.shape[1:])


def dynamics_partials_ad(x, u, dt, contact):
    """A = dxnext/dx, B = dxnext/du by forward-mode AD of `dynamics` (48
    tangents a sample): the reference for `dynamics_partials`.
    [..., 24, 24] each."""
    return _sample_jacfwd(dynamics, (0, 1), (x, u, dt, contact),
                          (1, 1, 0, 1))


def compute_hkd_state(eul, pos, qJ, contact):
    """Build qdummy from joint angles + FK (reference compute_hkd_state,
    HKDModel.h:66-96): joint angles for swing legs, foot positions for
    stance legs."""
    qd4 = qJ.unflatten(-1, (4, 3))
    pf = _feet_world(pos, eul, qd4)
    return torch.where(contact.unsqueeze(-1) > 0, pf, qd4).flatten(-2)


def _td_lo(contact_cur, contact_next):
    td4 = (1.0 - contact_cur) * contact_next       # touchdown
    lo4 = contact_cur * (1.0 - contact_next)       # liftoff
    return td4, lo4


def reset_map_td_lo(x, td4, lo4):
    """`reset_map` with precomputed per-leg touchdown / lift-off masks
    td4, lo4 [..., 4] (JAX package models/hkd.py:302)."""
    td, lo = td4.unsqueeze(-1), lo4.unsqueeze(-1)
    qd4 = x[..., 12:24].unflatten(-1, (4, 3))
    pf = _feet_world(x[..., 3:6], x[..., 0:3], qd4) \
        * _const((1.0, 1.0, 0.0), x)
    q_new = td * pf + lo * _const(QLEG_DEFAULT, x) + (1.0 - td - lo) * qd4
    return torch.cat([x[..., 0:12], q_new.flatten(-2)], dim=-1)


def reset_map(x, contact_cur, contact_next):
    """Hybrid reset of qdummy at a contact-mode switch (HKDReset.h:41-75).

    stance->swing: qdummy_leg := default joint angle.
    swing->stance: qdummy_leg := [pf_x, pf_y, 0] via FK from joint angles.
    """
    return reset_map_td_lo(x, *_td_lo(contact_cur, contact_next))


def reset_map_partial_ad(x, contact_cur, contact_next):
    """Px = d reset / dx by forward-mode AD of `reset_map` (24 tangents a
    sample): the reference for `reset_map_partial`.  [..., 24, 24]."""
    return _sample_jacfwd(reset_map, 0, (x, contact_cur, contact_next),
                          (1, 1, 1))


def reset_map_partial_td_lo(x, td4, lo4):
    """`reset_map_partial` with precomputed per-leg touchdown / lift-off
    masks td4, lo4 [..., 4] (JAX package models/hkd.py:333)."""
    shape = torch.broadcast_shapes(x.shape[:-1], td4.shape[:-1])
    td = td4.expand(shape + (4,))[..., None, None]       # [..., 4, 1, 1]
    keep = (1.0 - td - lo4.expand(shape + (4,))[..., None, None])
    qd4 = x[..., 12:24].unflatten(-1, (4, 3))
    R, dR_dy, dR_dp, dR_dr = _rot_derivs(x[..., 0:3])
    p_l = _legs_fk_local(qd4)                             # [..., 4, 3]
    J_eul = torch.stack([torch.einsum("...ij,...lj->...li", d, p_l)
                         for d in (dR_dy, dR_dp, dR_dr)], dim=-1)
    J_q = R.unsqueeze(-3) @ _legs_jacobian_local(qd4)     # [..., 4, 3, 3]
    zmask = _const((1.0, 1.0, 0.0), x)[:, None]
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    blk_eul = (td * zmask * J_eul).expand(shape + (4, 3, 3))
    blk_pos = (td * torch.diag(zmask[:, 0])).expand(shape + (4, 3, 3))
    blk_q = (td * zmask * J_q + keep * eye3).expand(shape + (4, 3, 3))
    # leg rows: [d/deul, d/dpos, 0 (omega, v), block-diagonal d/dqdummy]
    blk_qd = torch.einsum("...lij,lm->...limj", blk_q,
                          torch.eye(4, dtype=x.dtype, device=x.device))
    rows_leg = torch.cat([blk_eul, blk_pos, x.new_zeros(shape + (4, 3, 6)),
                          blk_qd.flatten(-2)], dim=-1).flatten(-3, -2)
    rows_body = torch.cat([
        torch.eye(12, dtype=x.dtype, device=x.device).expand(
            shape + (12, 12)),
        x.new_zeros(shape + (12, 12))], dim=-1)
    return torch.cat([rows_body, rows_leg], dim=-2)


def reset_map_partial(x, contact_cur, contact_next):
    """Px = d reset / dx (HKDReset.h:78-136), closed form: identity for
    unchanged legs, zero rows for stance->swing legs, and the z-masked
    foot Jacobian for swing->stance legs.  [..., 24, 24]."""
    return reset_map_partial_td_lo(x, *_td_lo(contact_cur, contact_next))


def foot_heights(x):
    """World-frame foot z for all 4 legs: [..., 4]."""
    p_l = _legs_fk_local(x[..., 12:24].unflatten(-1, (4, 3)))
    Rz = eul_to_rot(x[..., 0:3])[..., 2, :]
    return x[..., 5:6] + torch.einsum("...lj,...j->...l", p_l, Rz)


def touchdown_height_partials(x):
    """dh/dx for h_l = foot_z(pos, eul, qdummy_leg), all 4 legs: [..., 4, 24]
    (reference TouchDownConstraint partials, HKDConstraints.cpp:122-160)."""
    qd4 = x[..., 12:24].unflatten(-1, (4, 3))
    R, dR_dy, dR_dp, dR_dr = _rot_derivs(x[..., 0:3])
    p_l = _legs_fk_local(qd4)                               # [..., 4, 3]
    dR_z = torch.stack([dR_dy[..., 2, :], dR_dp[..., 2, :],
                        dR_dr[..., 2, :]], dim=-2)          # [..., 3, 3]
    heul = torch.einsum("...lj,...ej->...le", p_l, dR_z)    # [..., 4, 3]
    hq = torch.einsum("...j,...ljk->...lk", R[..., 2, :],
                      _legs_jacobian_local(qd4))            # [..., 4, 3]
    shape = heul.shape[:-2]
    hpos = _const((0.0, 0.0, 1.0), x).expand(shape + (4, 3))
    hqd = torch.einsum("...lk,lm->...lmk", hq,
                       torch.eye(4, dtype=x.dtype, device=x.device))
    return torch.cat([heul, hpos, x.new_zeros(shape + (4, 6)),
                      hqd.flatten(-2)], dim=-1)

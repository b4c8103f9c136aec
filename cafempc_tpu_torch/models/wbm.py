"""Whole-body model (WBM): 36-state contact-constrained dynamics (port of
`cafempc_tpu/models/wbm.py`).

Functional mirror of the reference WBM::Model (MHPC/MHPC-Trajopt/WBM.{h,cpp}):
  state x = [q(18), v(18)],  q = [pos, yaw, pitch, roll, qJ(12)],  v = q̇
  control u = 12 joint torques,  output y = 12 world-frame GRFs.

All heavy lifting lives in `rbda`; every function takes any leading batch
dimensions (x [..., 36], u [..., 12], contact [..., 4], dt a number or a
tensor [...]).  Leg order FL, FR, HL, HR (urdf convention).
"""
import torch

from cafempc_tpu_torch.models import rbda
from cafempc_tpu_torch.models.urdf import load_urdf_floating_base

XS = 36
US = 12
YS = 12
NQ = 18
NV = 18


def load_model(urdf_path, device="cuda", dtype=torch.float32):
    """The rigid-body model of a URDF at the solve's dtype and device."""
    return rbda.build_model(load_urdf_floating_base(urdf_path), device,
                            dtype)


def _tau_full(u):
    """Selection matrix action (WBM.h:38-47): actuate the last 12 dofs."""
    return torch.cat([u.new_zeros(*u.shape[:-1], 6), u], -1)


def _col(dt):
    """dt (a number or a tensor [...]) as a factor of [..., n] rows."""
    return dt[..., None] if torch.is_tensor(dt) else dt


def dynamics_continuous(model, x, u, contact, bg_alpha=10.0):
    """(WBM.cpp:38-57).  Returns (xdot [..., 36], GRF [..., 12])."""
    q, v = x[..., :NQ], x[..., NQ:]
    qdd, grf = rbda.contact_kkt_dynamics(model, q, v, _tau_full(u), contact,
                                         bg_alpha)
    return torch.cat([v, qdd], -1), grf


def dynamics(model, x, u, dt, contact, bg_alpha=10.0):
    """Forward-Euler discrete step (WBM.cpp:17-32).  Returns (xnext, GRF)."""
    q, v = x[..., :NQ], x[..., NQ:]
    xdot, grf = dynamics_continuous(model, x, u, contact, bg_alpha)
    dt = _col(dt)
    return torch.cat([q + v * dt, v + xdot[..., NQ:] * dt], -1), grf


def dynamics_partials(model, x, u, dt, contact, bg_alpha=10.0):
    """A, B, C, D by forward-mode AD through the step (reference:
    WBM.cpp:59-139)."""
    def step(z):
        return dynamics(model, z[..., :XS], z[..., XS:], dt, contact,
                        bg_alpha)
    Jx, Jy = rbda.batched_jacobian(step, torch.cat([x, u], -1))
    return Jx[..., :XS], Jx[..., XS:], Jy[..., :XS], Jy[..., XS:]


def dynamics_partials_analytic(model, x, u, dt, contact, bg_alpha=10.0):
    """A, B, C, D from the factored-KKT analytic assembly
    (rbda.contact_kkt_dynamics_partials, the reference's
    WBM::KKTContactDynamicsDerivatives structure, WBM.cpp:459-505)."""
    q, v = x[..., :NQ], x[..., NQ:]
    return _discrete_partials(dt, *rbda.contact_kkt_dynamics_partials(
        model, q, v, _tau_full(u), contact, bg_alpha))


def _discrete_partials(dt, dqdd_dq, dqdd_dv, dqdd_dtau, dlam_dq, dlam_dv,
                       dlam_dtau):
    """A, B, C, D of xnext = [q + v dt; v + qdd dt] and the GRFs from the
    contact dynamics' partials (dt a number or a tensor [...])."""
    dt = _col(_col(dt))
    eye = torch.eye(NQ, dtype=dqdd_dq.dtype,
                    device=dqdd_dq.device).expand_as(dqdd_dq)
    A = torch.cat([torch.cat([eye, dt * eye], -1),
                   torch.cat([dt * dqdd_dq, eye + dt * dqdd_dv], -1)], -2)
    B = torch.cat([torch.zeros_like(dqdd_dtau[..., 6:]),
                   dt * dqdd_dtau[..., 6:]], -2)
    C = torch.cat([dlam_dq, dlam_dv], -1)
    return A, B, C, dlam_dtau[..., 6:]


def impact_partial_analytic(model, x, contact_cur, contact_next):
    """Px for the impulse reset from the factored KKT
    (rbda.impulse_dynamics_partials; WBM.cpp:508-543)."""
    q, v = x[..., :NQ], x[..., NQ:]
    impact_mask = (1.0 - contact_cur) * contact_next
    return impact_jacobian(*rbda.impulse_dynamics_partials(model, q, v,
                                                           impact_mask))


def impact_jacobian(dvp_dq, dvp_dv):
    """Px [..., 36, 36] = [I 0; dvp_dq dvp_dv] of the impulse reset (q
    passes through) from the post-impact velocity's partials."""
    eye = torch.eye(NQ, dtype=dvp_dq.dtype,
                    device=dvp_dq.device).expand_as(dvp_dq)
    return torch.cat([torch.cat([eye, torch.zeros_like(dvp_dq)], -1),
                      torch.cat([dvp_dq, dvp_dv], -1)], -2)


def impact(model, x, contact_cur, contact_next):
    """Impulse reset at touchdown (WBM.cpp:178-206).  Legs entering contact
    get an inelastic impact; q unchanged.  Returns (xnext, impulse)."""
    q, v = x[..., :NQ], x[..., NQ:]
    impact_mask = (1.0 - contact_cur) * contact_next
    v_post, imp = rbda.impulse_dynamics(model, q, v, impact_mask)
    return torch.cat([q, v_post], -1), imp


def impact_partial(model, x, contact_cur, contact_next):
    """d impact / dx by forward-mode AD [..., 36, 36]."""
    return rbda.batched_jacobian(
        lambda x_: impact(model, x_, contact_cur, contact_next)[0], x)


def foot_positions(model, x):
    return rbda.foot_kinematics(model, x[..., :NQ])


def foot_velocities(model, x):
    return rbda.foot_velocities(model, x[..., :NQ], x[..., NQ:])


def foot_jacobians(model, x):
    """[..., 4, 3, 18]: d foot / d q (WBM.cpp:349-364)."""
    return rbda.foot_jacobians(model, x[..., :NQ])


def foot_vel_dq(model, x):
    """[..., 4, 3, 18]: d foot velocity / d q (casadi footVelPartialDq)."""
    return rbda.foot_vel_dq(model, x[..., :NQ], x[..., NQ:])


def foot_heights(model, x):
    return foot_positions(model, x)[..., 2]


def centroidal_momentum(model, x):
    return rbda.centroidal_angular_momentum(model, x[..., :NQ], x[..., NQ:])

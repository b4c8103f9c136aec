# Frozen copy of cafempc_tpu_torch/models/srb.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Single-rigid-body (SRB) model for the cascaded-fidelity tail horizon
(port of `cafempc_tpu/models/srb.py`), batched over leading dimensions.

State (12):   [pos(3), eul(3: yaw,pitch,roll), vWorld(3), eulrate(3)]
Control (12): GRF_world per leg (FL, FR, HL, HR in MHPC/urdf convention)
Inputs:       world foot positions (12) + contact mask (4)

Mirrors (behavior, not code) the reference's generated `SRBDynamics` /
`SRBDynamicsDerivatives` kernels (MHPC/MHPC-Trajopt/SRBM.h:43-93), held to
tests/fixtures/srb_dynamics.npz.  Every function takes x, u, p_feet
[..., 12] and contact [..., 4]; the mass and inertia are made at the
input's dtype and device.
"""
import numpy as np
import torch
from torch.func import jvp

from benchmark.reference.plain.models.rbda import batched_jacobian
from benchmark.reference.plain.utils.rotations import (
    eul_to_rot, euldrate_to_omega_mat, omega_to_euldrate_mat)

XS = 12
US = 12
YS = 0

MASS = 8.912
INERTIA = np.array([
    [0.061578036, 0.0, 5.38e-05],
    [0.0, 0.2207093, 0.0],
    [5.38e-05, 0.0, 0.272612336],
])
GRAVITY = 9.81


def inertia(like):
    """(INERTIA, its inverse) at like's dtype and device: omega_dot takes
    the constant inverse, where a solve would sync the host on CUDA to
    check the factorization."""
    return (torch.tensor(INERTIA, dtype=like.dtype, device=like.device),
            torch.tensor(np.linalg.inv(INERTIA), dtype=like.dtype,
                         device=like.device))


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def dynamics_continuous(x, u, p_feet, contact):
    """xdot = f(x, u; p_feet, contact) [..., 12]."""
    pos, eul = x[..., 0:3], x[..., 3:6]
    vel, euld = x[..., 6:9], x[..., 9:12]
    R = eul_to_rot(eul)
    omega = _mv(euldrate_to_omega_mat(eul), euld)

    f = u.unflatten(-1, (4, 3)) * contact[..., None]
    r = p_feet.unflatten(-1, (4, 3)) - pos[..., None, :]
    tau_b = _mv(R.mT, torch.linalg.cross(r, f, dim=-1).sum(-2))

    I, I_inv = inertia(x)
    omega_dot = _mv(I_inv, tau_b - torch.linalg.cross(omega, _mv(I, omega),
                                                      dim=-1))

    # euldd = Binv @ (omega_dot - Bdot @ euld), Bdot via jvp through eul
    Bdot = jvp(euldrate_to_omega_mat, (eul,), (euld,))[1]
    euldd = _mv(omega_to_euldrate_mat(eul), omega_dot - _mv(Bdot, euld))

    v_dot = f.sum(-2) / MASS
    v_dot = torch.cat([v_dot[..., :2], v_dot[..., 2:] - GRAVITY], -1)
    return torch.cat([vel, euld, v_dot, euldd], -1)


def dynamics(x, u, p_feet, contact, dt):
    """Discrete forward-Euler step (reference SRBM.h:43-49); dt a number or
    a tensor [...]."""
    dt = dt[..., None] if torch.is_tensor(dt) else dt
    return x + dt * dynamics_continuous(x, u, p_feet, contact)


def _partials(f, x, u):
    """(df/dx, df/du) of f(x, u) -> [..., 12] by one batched Jacobian."""
    J = batched_jacobian(lambda z: f(z[..., :XS], z[..., XS:]),
                         torch.cat([x, u], -1))
    return J[..., :XS], J[..., XS:]


def dynamics_partials_continuous(x, u, p_feet, contact):
    """(Ac, Bc), each [..., 12, 12]."""
    return _partials(lambda x_, u_: dynamics_continuous(x_, u_, p_feet,
                                                        contact), x, u)


def dynamics_partials(x, u, p_feet, contact, dt):
    """A = I + Ac*dt, B = Bc*dt (reference SRBM.h:66-75)."""
    return _partials(lambda x_, u_: dynamics(x_, u_, p_feet, contact, dt),
                     x, u)

# Frozen copy of cafempc_tpu_torch/utils/rotations.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""ZYX-Euler rotation utilities, batched over leading dimensions.

Port of `cafempc_tpu/utils/rotations.py`: ``eul = (yaw, pitch, roll)``,
``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)`` maps body -> world, and body angular
velocity relates to Euler rates via ``omega_b = B(eul) @ euld``.
"""
import torch


def _mat3(rows):
    """Stack a 3x3 nested list of same-shape tensors into [..., 3, 3]."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rotz(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _mat3([[c, -s, z], [s, c, z], [z, z, o]])


def roty(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _mat3([[c, z, s], [z, o, z], [-s, z, c]])


def rotx(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _mat3([[o, z, z], [z, c, -s], [z, s, c]])


def eul_to_rot(eul):
    """Body->world rotation from (yaw, pitch, roll): [..., 3] -> [..., 3, 3]."""
    return rotz(eul[..., 0]) @ roty(eul[..., 1]) @ rotx(eul[..., 2])


def euldrate_to_omega_mat(eul):
    """B(eul): omega_b = B @ euld (ZYX)."""
    sp, cp = torch.sin(eul[..., 1]), torch.cos(eul[..., 1])
    sr, cr = torch.sin(eul[..., 2]), torch.cos(eul[..., 2])
    z, o = torch.zeros_like(sp), torch.ones_like(sp)
    return _mat3([[-sp, z, o], [cp * sr, cr, z], [cp * cr, -sr, z]])


def omega_to_euldrate_mat(eul):
    """B(eul)^-1 in closed form: euld = Binv @ omega_b."""
    sp, cp = torch.sin(eul[..., 1]), torch.cos(eul[..., 1])
    sr, cr = torch.sin(eul[..., 2]), torch.cos(eul[..., 2])
    z, o = torch.zeros_like(sp), torch.ones_like(sp)
    return _mat3([[z, sr / cp, cr / cp],
                  [z, cr, -sr],
                  [o, sp * sr / cp, sp * cr / cp]])


def skew(v):
    """3-vector -> skew-symmetric matrix: [..., 3] -> [..., 3, 3]."""
    z = torch.zeros_like(v[..., 0])
    return _mat3([[z, -v[..., 2], v[..., 1]],
                  [v[..., 2], z, -v[..., 0]],
                  [-v[..., 1], v[..., 0], z]])

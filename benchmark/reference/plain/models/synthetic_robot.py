# Frozen copy of cafempc_tpu_torch/models/synthetic_robot.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""A synthetic quadruped URDF in place of the reference's Mini Cheetah URDF
(`urdf/mini_cheetah_simple_correctedInertia.urdf`, not in this repository),
as `reference/synthetic.py` stands in for the gait CSV.

Its kinematics is the Mini Cheetah's, from the leg constants of
`models/hkd.py` (hip offsets +-0.19 / +-0.049, abad link 0.062, thigh
0.209, shank 0.195):
  * abad joints about +x at (+-0.19, +-0.049, 0) on the body;
  * hip joints at (0, +-0.062, 0) on the abad link, about (0, -1, 0);
  * knee joints at (0, 0, -0.209) on the thigh, about (0, -1, 0);
  * a fixed foot frame at (0, 0, -0.195) on the shank.
With the floating base of `urdf.load_urdf_floating_base` it reproduces the
reference's generated kinematics derivatives
(`tests/fixtures/wb_kin_derivs.npz`) to round-off.  Legs are written in
the order FL, FR, HL, HR; link masses are 3.3 (body), 0.54 (abad), 0.634
(thigh) and 0.064 (shank), 8.252 in all.

The link inertias and centres of mass are SYNTHETIC: positive definite
and of a plausible size for a 9 kg quadruped, but not the robot's.  So
the mass matrix, bias force and contact forces of this robot are compared
only between two implementations on this same file, never with the
robot's.
"""
import os

from benchmark.reference.plain.models import hkd

# the model's leg order FL, FR, HL, HR: (name, index into hkd's FR, FL,
# HR, HL leg constants)
LEGS = (("fl", 1), ("fr", 0), ("hl", 3), ("hr", 2))

BODY_MASS = 3.3
ABAD_MASS = 0.54
THIGH_MASS = 0.634
SHANK_MASS = 0.064
TOTAL_MASS = BODY_MASS + 4 * (ABAD_MASS + THIGH_MASS + SHANK_MASS)

# synthetic principal inertias (kg m^2) and CoM offsets (m, y mirrored per
# side)
BODY_INERTIA = (0.0115, 0.0365, 0.0425)
ABAD_INERTIA = (0.00038, 0.00056, 0.00044)
THIGH_INERTIA = (0.0020, 0.0021, 0.00041)
SHANK_INERTIA = (0.00025, 0.00025, 0.000012)
ABAD_COM = (0.0, 0.036, 0.0)
THIGH_COM = (0.0, 0.016, -0.02)
SHANK_COM = (0.0, 0.0, -0.061)


def _vec(v):
    return " ".join(repr(float(a)) for a in v)


def _link(name, mass=None, com=(0.0, 0.0, 0.0), inertia=None):
    if mass is None:
        return f'  <link name="{name}"/>\n'
    ixx, iyy, izz = inertia
    return (f'  <link name="{name}">\n'
            f'    <inertial>\n'
            f'      <origin xyz="{_vec(com)}" rpy="0 0 0"/>\n'
            f'      <mass value="{mass!r}"/>\n'
            f'      <inertia ixx="{ixx!r}" ixy="0" ixz="0" iyy="{iyy!r}" '
            f'iyz="0" izz="{izz!r}"/>\n'
            f'    </inertial>\n'
            f'  </link>\n')


def _joint(name, kind, parent, child, xyz, axis=None):
    ax = f'    <axis xyz="{_vec(axis)}"/>\n' if axis is not None else ""
    return (f'  <joint name="{name}" type="{kind}">\n'
            f'    <parent link="{parent}"/>\n'
            f'    <child link="{child}"/>\n'
            f'    <origin xyz="{_vec(xyz)}" rpy="0 0 0"/>\n'
            f'{ax}'
            f'  </joint>\n')


def synthetic_quadruped_urdf():
    """The URDF document as a string."""
    parts = ['<?xml version="1.0"?>\n<robot name="synthetic_quadruped">\n',
             _link("body", BODY_MASS, inertia=BODY_INERTIA)]
    for leg, i in LEGS:
        sy = hkd.SIDE_SIGN[i]
        abad, thigh, shank, foot = (f"{n}_{leg}" for n in
                                    ("abad", "thigh", "shank", "toe"))
        parts += [
            _link(abad, ABAD_MASS, (ABAD_COM[0], sy * ABAD_COM[1],
                                    ABAD_COM[2]), ABAD_INERTIA),
            _joint(f"abad_{leg}_joint", "revolute", "body", abad,
                   (hkd.HIP_X[i], hkd.HIP_Y[i], 0.0), (1.0, 0.0, 0.0)),
            _link(thigh, THIGH_MASS, (THIGH_COM[0], sy * THIGH_COM[1],
                                      THIGH_COM[2]), THIGH_INERTIA),
            _joint(f"hip_{leg}_joint", "revolute", abad, thigh,
                   (0.0, sy * hkd.L1, 0.0), (0.0, -1.0, 0.0)),
            _link(shank, SHANK_MASS, SHANK_COM, SHANK_INERTIA),
            _joint(f"knee_{leg}_joint", "revolute", thigh, shank,
                   (0.0, 0.0, -hkd.L2), (0.0, -1.0, 0.0)),
            _link(foot),
            _joint(f"toe_{leg}_joint", "fixed", shank, foot,
                   (0.0, 0.0, -hkd.L3)),
        ]
    parts.append("</robot>\n")
    return "".join(parts)


def write_synthetic_quadruped_urdf(path):
    """Write the synthetic quadruped's URDF to `path` (a file, or a
    directory that gets `synthetic_quadruped.urdf`); returns the file's
    path."""
    if os.path.isdir(path):
        path = os.path.join(path, "synthetic_quadruped.urdf")
    with open(path, "w") as f:
        f.write(synthetic_quadruped_urdf())
    return path

# Frozen copy of cafempc_tpu_torch/models/urdf.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Minimal URDF parser -> kinematic-tree arrays for the RBDA layer (port of
`cafempc_tpu/models/urdf.py`, kept as the port's own numpy copy).

The floating base is modeled as in the reference's pinocchio URDF pipeline
(MHPC/MHPC-Trajopt/PinocchioInteface.cpp:5-59): a PX,PY,PZ,RZ,RY,RX chain
of single-dof joints prepended to the URDF tree, so q = [x,y,z,yaw,pitch,
roll, qJ...] and v = q̇ (WBM.h:13-19).

Output is a plain dataclass of numpy arrays with static topology, turned
into tensors at the solve's dtype and device by
`benchmark.reference.plain.models.rbda.build_model`.
"""
import dataclasses
import xml.etree.ElementTree as ET

import numpy as np


def _rpy_to_rot(rpy, snap_pi=True):
    """rpy -> rotation matrix.  `snap_pi` snaps values within 1e-3 of ±pi
    to exact ±pi: the mini-cheetah URDF writes 3.1415/3.141592 but the
    reference's generated kinematics kernels were built with exact pi
    (snapping gives <1e-14 agreement with the golden fixtures, ~6e-5
    without)."""
    if snap_pi:
        rpy = np.where(np.abs(np.abs(rpy) - np.pi) < 1e-3,
                       np.sign(rpy) * np.pi, rpy)
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


# joint type codes
REVOLUTE = 0
PRISMATIC = 1


@dataclasses.dataclass
class TreeModel:
    """Kinematic tree with nd single-dof joints (floating base included).

    Arrays (numpy, host-side):
      parent[nd]      : parent dof index (-1 = world)
      jtype[nd]       : REVOLUTE | PRISMATIC
      axis[nd,3]      : joint axis in the post-origin (child) frame
      R_tree[nd,3,3]  : fixed rotation parent->joint frame
      p_tree[nd,3]    : joint-frame origin in parent frame
      mass[nd]        : mass of the body attached to dof i (0 if none)
      com[nd,3]       : body CoM in the body (child) frame
      inertia[nd,3,3] : rotational inertia about the CoM, body frame
      frames          : list of (name, dof_idx, R_fix, p_fix) end-effector
                        frames (from fixed joints, e.g. feet)
      joint_names     : names of the actuated (non-base) dofs, URDF order
    """
    parent: np.ndarray
    jtype: np.ndarray
    axis: np.ndarray
    R_tree: np.ndarray
    p_tree: np.ndarray
    mass: np.ndarray
    com: np.ndarray
    inertia: np.ndarray
    frames: list
    joint_names: list

    @property
    def nd(self):
        return len(self.parent)


def _floats(text):
    """A URDF vector attribute ("x y z") -> float64 array."""
    return np.array(text.split(), dtype=np.float64)


def _parse_inertial(link_el):
    inertial = link_el.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(inertial.find("mass").get("value"))
    origin = inertial.find("origin")
    com = np.zeros(3)
    if origin is not None and origin.get("xyz"):
        com = _floats(origin.get("xyz"))
    it = inertial.find("inertia")
    ixx = float(it.get("ixx", 0))
    iyy = float(it.get("iyy", 0))
    izz = float(it.get("izz", 0))
    ixy = float(it.get("ixy", 0))
    ixz = float(it.get("ixz", 0))
    iyz = float(it.get("iyz", 0))
    I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    return mass, com, I


def _origin(el):
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    o = el.find("origin")
    if o is not None:
        if o.get("xyz"):
            xyz = _floats(o.get("xyz"))
        if o.get("rpy"):
            rpy = _floats(o.get("rpy"))
    return _rpy_to_rot(rpy), xyz


def load_urdf_floating_base(fname) -> TreeModel:
    """Parse a URDF and prepend the PX,PY,PZ,RZ,RY,RX floating-base chain.

    The URDF root link's inertia rides on the RX dof (index 5), exactly as
    pinocchio's appendModel attaches it to the base chain's last joint in
    the reference construction.
    """
    root = ET.parse(fname).getroot()
    links = {l.get("name"): l for l in root.findall("link")}
    joints = root.findall("joint")

    # child link -> joint element (moving joints only, URDF document order)
    parent_of_link = {}
    for j in joints:
        parent_of_link[j.find("child").get("link")] = j

    # find root link (no parent joint)
    root_links = [n for n in links if n not in parent_of_link]
    if len(root_links) != 1:
        raise ValueError(f"{fname}: expected one root link, got {root_links}")
    root_link = root_links[0]

    parent = list(range(-1, 5))            # chain: -1,0,1,2,3,4
    jtype = [PRISMATIC, PRISMATIC, PRISMATIC, REVOLUTE, REVOLUTE, REVOLUTE]
    axis = [np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
            np.array([0, 0, 1.0]), np.array([0, 0, 1.0]),
            np.array([0, 1.0, 0]), np.array([1.0, 0, 0])]
    R_tree = [np.eye(3) for _ in range(6)]
    p_tree = [np.zeros(3) for _ in range(6)]
    mass = [0.0] * 6
    com = [np.zeros(3)] * 6
    inertia = [np.zeros((3, 3))] * 6

    m, c, I = _parse_inertial(links[root_link])
    mass[5], com[5], inertia[5] = m, c, I

    link_dof = {root_link: 5}
    frames = []
    joint_names = []

    # walk moving joints in document order (matches pinocchio's appendModel
    # ordering for this URDF: legs fl, fr, hl, hr; abad, hip, knee each)
    for j in joints:
        jt = j.get("type")
        parent_link = j.find("parent").get("link")
        child_link = j.find("child").get("link")
        R0, p0 = _origin(j)
        if jt == "fixed":
            # end-effector frame on the parent dof
            pdof = link_dof[parent_link]
            frames.append((child_link, pdof, R0, p0))
            link_dof[child_link] = pdof
            continue
        if jt not in ("revolute", "continuous"):
            raise ValueError(f"{fname}: joint type {jt!r} is not supported")
        ax = _floats(j.find("axis").get("xyz")) \
            if j.find("axis") is not None else np.array([1.0, 0, 0])
        idx = len(parent)
        parent.append(link_dof[parent_link])
        jtype.append(REVOLUTE)
        axis.append(ax)
        R_tree.append(R0)
        p_tree.append(p0)
        m, c, I = _parse_inertial(links[child_link])
        mass.append(m)
        com.append(c)
        inertia.append(I)
        link_dof[child_link] = idx
        joint_names.append(j.get("name"))

    return TreeModel(
        parent=np.asarray(parent, dtype=np.int32),
        jtype=np.asarray(jtype, dtype=np.int32),
        axis=np.asarray(axis, dtype=np.float64),
        R_tree=np.asarray(R_tree, dtype=np.float64),
        p_tree=np.asarray(p_tree, dtype=np.float64),
        mass=np.asarray(mass, dtype=np.float64),
        com=np.asarray(com, dtype=np.float64),
        inertia=np.asarray(inertia, dtype=np.float64),
        frames=frames, joint_names=joint_names)

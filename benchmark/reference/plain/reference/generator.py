# Frozen copy of cafempc_tpu_torch/reference/generator.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Offline reference-trajectory generator (port of
`cafempc_tpu/reference/generator.py`).

Re-implementation of the reference's Python tooling
(scripts/Reference_python/{gen_regular,reference_management,
body_trajectory_plan,foothold_plan,swing_trajectory_plan}.py) without
PyBullet: joint references come from an analytic-Jacobian Newton IK over
the port's whole-body kinematics (`models/rbda.py`).

Pipeline (gen_regular.py:32-86): gait schedule -> CoM plan (velocity ramp)
-> Raibert footholds -> swing trajectories -> per-knot IK -> csv in the
exact quad_reference.csv keyed-line format (urdf leg order FL,FR,HL,HR).

Everything but the IK is host-side numpy.  The IK runs on the model's
device and dtype, one knot after another: each knot's Newton iteration
starts from the previous knot's joint angles, as in the JAX package, so
the knots cannot be batched without changing the result.
"""
import numpy as np
import torch

from benchmark.reference.plain.models import rbda
from benchmark.reference.plain.reference import gait as gait_mod
from benchmark.reference.plain.reference.quad_reference import QuadReferenceData

# Default foothold offsets w.r.t. CoM (foothold_plan.py:6-10)
DEFAULT_FOOTHOLDS = np.array([
    [0.22, 0.10, 0.0], [0.22, -0.10, 0.0],
    [-0.18, 0.10, 0.0], [-0.18, -0.10, 0.0]])

TOTAL_MASS = 8.252
G = 9.81
N_IK_STEPS = 8
QJ_STAND = np.tile([0.0, -0.8, 1.6], 4)


class CoMPlan:
    """Velocity ramp 0 -> v_des over transition_time, constant height
    (body_trajectory_plan.py behavior)."""

    def __init__(self, p0, v_des, z_des, transition_time):
        self.p0 = np.asarray(p0, dtype=float)
        self.v_des = np.asarray(v_des, dtype=float)
        self.T = transition_time
        self.z = z_des

    def vel(self, t):
        a = min(t / self.T, 1.0) if self.T > 0 else 1.0
        v = a * self.v_des
        return np.array([v[0], v[1], 0.0])

    def pos(self, t):
        if self.T > 0 and t < self.T:
            p_xy = self.p0[:2] + 0.5 * t * t / self.T * self.v_des
        else:
            p_xy = self.p0[:2] + self.v_des * (t - 0.5 * self.T)
        return np.array([p_xy[0], p_xy[1], self.z])


def _swing_interp(p0, p1, h, s):
    """Swing foot trajectory: smooth xy blend + sine height bump; returns
    (pos, d pos/d s)."""
    blend = 0.5 * (1.0 - np.cos(np.pi * s))
    dblend = 0.5 * np.pi * np.sin(np.pi * s)
    xy = p0[:2] + blend * (p1[:2] - p0[:2])
    dxy = dblend * (p1[:2] - p0[:2])
    z = p0[2] + blend * (p1[2] - p0[2]) + h * np.sin(np.pi * s)
    dz = dblend * (p1[2] - p0[2]) + h * np.pi * np.cos(np.pi * s)
    return (np.array([xy[0], xy[1], z]), np.array([dxy[0], dxy[1], dz]))


def make_leg_ik(model):
    """Newton IK for all four legs at once on `model` (`wbm.load_model`):
    ik(pos [3], eul [3], pf_target [12], qJ0 [12]) -> qJ [12] such that the
    world foot positions match the targets at the given body pose, on the
    model's device and dtype.  Replaces mini_cheetah_pybullet.ik.

    Each of the N_IK_STEPS steps solves the four legs' 3 x 3 systems
    (J_leg + 1e-9 I) dq = err (JAX generator.py:65-90) in one batched LU
    solve, with no host sync."""
    reg = 1e-9 * torch.eye(3, dtype=model.mass.dtype, device=model.mass.device)

    def ik(pos, eul, pf_target, qJ0):
        base = torch.cat([pos, eul])
        qJ = qJ0
        for _ in range(N_IK_STEPS):
            q = torch.cat([base, qJ])
            pf, J = rbda.foot_kinematics_and_jacobians(model, q)
            # the legs' own 3 x 3 blocks: J[leg, :, 6 + 3 leg + j]
            Jl = torch.diagonal(J[:, :, 6:].unflatten(-1, (4, 3)),
                                dim1=0, dim2=2).permute(2, 0, 1)
            err = (pf_target - pf.reshape(12)).reshape(4, 3, 1)
            dq = torch.linalg.solve_ex(Jl + reg, err)[0]
            qJ = qJ + dq.reshape(12)
        return qJ

    return ik


def ik_chain(model, pos, eul, pf, qJ0):
    """Joint angles [K, 12] (numpy) of K knots solved one after another,
    each Newton iteration warm-started from the previous knot's result and
    the first from qJ0: pos, eul [K, 3], pf [K, 12] numpy targets.  One
    copy to the model's device and one back."""
    if len(pos) == 0:
        return np.zeros((0, 12))
    ik = make_leg_ik(model)
    dev, dt = model.mass.device, model.mass.dtype
    pos_t, eul_t, pf_t = (torch.as_tensor(np.asarray(a, np.float64)).to(
        dev, dt) for a in (pos, eul, pf))
    qJ = torch.as_tensor(np.asarray(qJ0, np.float64)).to(dev, dt)
    out = []
    for k in range(len(pos)):
        qJ = ik(pos_t[k], eul_t[k], pf_t[k], qJ)
        out.append(qJ)
    return torch.stack(out).cpu().numpy().astype(np.float64)


def generate_reference(gait_name="trot", duration=10.0, vx=0.5, vy=0.0,
                       z_des=0.24, swing_height=0.06, dt=0.01,
                       transition_time=2.5, initial_stance=0.05,
                       end_stance=0.15, *, model, schedule=None):
    """Build a QuadReferenceData for a regular gait (gen_regular.py) on the
    whole-body model `model` (`wbm.load_model(urdf_path, device, dtype)`;
    the IK runs on its device).

    schedule: optional explicit (contacts, switching_times) mode schedule
    (gait.build_schedule_from_gaits) overriding the periodic gait — the
    composed-schedule path of gen_run_jump.py.
    """
    if schedule is not None:
        contacts, times = schedule
        duration = float(times[-1])
        end_stance = 0.0
    else:
        g = gait_mod.GAITS[gait_name]
        contacts, times = gait_mod.build_mode_schedule(
            g, duration, initial_stance, end_stance)
    com = CoMPlan([0.0, 0.0, z_des], [vx, vy], z_des, transition_time)

    # footholds per leg-mode interval (foothold_plan.py:20-60)
    leg_iv = [gait_mod.leg_intervals(contacts, times, l) for l in range(4)]
    footholds = []
    for l in range(4):
        iv = leg_iv[l]
        fhs = [com.pos(0) + DEFAULT_FOOTHOLDS[l]]
        for i in range(1, len(iv)):
            status, ts, te = iv[i]
            if status == 0:
                td = te
                stance_T = (iv[i + 1][2] - td) if i + 1 < len(iv) else 0.2
                cp, cv = com.pos(td), com.vel(td)
                off = np.minimum(cv[:2] * stance_T / 2.0, 0.2) \
                    + DEFAULT_FOOTHOLDS[l][:2]
                fhs.append(np.array([cp[0] + off[0], cp[1] + off[1], 0.0]))
            else:
                fhs.append(fhs[i - 1])
        for i in range(len(fhs)):
            fhs[i] = np.array([fhs[i][0], fhs[i][1], 0.0])
        footholds.append(fhs)

    def leg_mode_idx(l, t):
        iv = leg_iv[l]
        for i, (s, ts, te) in enumerate(iv):
            if ts - 1e-9 <= t < te - 1e-9:
                return i
        return len(iv) - 1

    # total mass for the nominal stance GRF: the robot model's, summed on
    # the host in f64 as the JAX generator sums it
    total_mass = float(model.mass.double().cpu().numpy().sum())
    N = int(round((times[-1]) / dt)) + 1
    T = min(N, int(round(duration / dt)) + 1 + int(round(end_stance / dt)))

    recs = dict(body_state=[], qJd=[], foot_placements=[],
                foot_velocities=[], foot_heights=[], grf=[], torque=[],
                contact=[], status_dur=[])
    for k in range(T):
        t = k * dt
        c = gait_mod.contact_at(contacts, times, t)
        pos = com.pos(t)
        vel = com.vel(t)
        pf = np.zeros(12)
        vf = np.zeros(12)
        sdur = np.zeros(4)
        for l in range(4):
            i = leg_mode_idx(l, t)
            status, ts, te = leg_iv[l][i]
            sdur[l] = te - ts
            if status == 1:
                pf[3 * l:3 * l + 3] = footholds[l][i]
            else:
                p0 = footholds[l][i - 1] if i > 0 else footholds[l][0]
                p1 = footholds[l][min(i + 1, len(footholds[l]) - 1)]
                s = (t - ts) / max(te - ts, 1e-9)
                p, dp_ds = _swing_interp(p0, p1, swing_height, s)
                pf[3 * l:3 * l + 3] = p
                vf[3 * l:3 * l + 3] = dp_ds / max(te - ts, 1e-9)
        n_st = max(int(c.sum()), 1)
        grf = np.zeros(12)
        for l in range(4):
            if c[l]:
                grf[3 * l + 2] = total_mass * G / n_st
        recs["body_state"].append(np.concatenate([pos, np.zeros(3), vel,
                                                  np.zeros(3)]))
        recs["qJd"].append(np.zeros(12))
        recs["foot_placements"].append(pf)
        recs["foot_velocities"].append(vf)
        recs["foot_heights"].append(pf[2::3].copy())
        recs["grf"].append(grf)
        recs["torque"].append(np.zeros(12))
        recs["contact"].append(c.astype(np.int32))
        recs["status_dur"].append(sdur)

    data = {k: np.asarray(v) for k, v in recs.items()}
    bs = data["body_state"]
    qJ = ik_chain(model, bs[:, 0:3], np.zeros((T, 3)),
                  data["foot_placements"], QJ_STAND)
    return QuadReferenceData(dt=dt, qJ=qJ, **data)


def write_quad_reference_csv(data: QuadReferenceData, path):
    """Emit the exact keyed-line quad_reference.csv format the C++ loader
    parses (QuadReference.cpp:134-356).  body_state on file is
    [eul, pos, eulrate, vel]."""
    def fmt(v):
        return " ".join(f"{x:8.4f}" for x in v)

    with open(path, "w") as fh:
        fh.write("dt\n%.3f\n" % data.dt)
        for k in range(len(data)):
            bs = data.body_state[k]
            on_file = np.concatenate([bs[3:6], bs[0:3], bs[9:12], bs[6:9]])
            fh.write("body_state \n" + fmt(on_file) + " \n")
            fh.write("jnt_angle\n" + fmt(data.qJ[k]) + " \n")
            fh.write("jnt_vel\n" + fmt(data.qJd[k]) + " \n")
            fh.write("foot_placements\n" + fmt(data.foot_placements[k])
                     + " \n")
            fh.write("foot_velocities\n" + fmt(data.foot_velocities[k])
                     + " \n")
            fh.write("grf\n" + fmt(data.grf[k]) + " \n")
            fh.write("torque\n" + fmt(data.torque[k]) + " \n")
            fh.write("contact\n"
                     + " ".join(str(int(x)) for x in data.contact[k])
                     + " \n")
            fh.write("status_dur\n" + fmt(data.status_dur[k]) + " \n")

"""Acrobatic reference generation: in-place barrel roll + running jump
(port of `cafempc_tpu/reference/acrobatic.py`).

Re-implementation of the reference's acrobatic generators:
  * barrel roll (scripts/Reference_python/barrel_roll.py + gen_barrel.py):
    the CoM follows a ballistic arc during flight (projectile_pos/vel,
    utils.py:16-26), the roll angle ramps 0 -> 2*pi across the flight
    window, legs tuck at a fixed joint posture, and the schedule is
    stance -> flight -> stance.
  * running jump (gen_run_jump.py): the regular-gait pipeline with a
    composed mode schedule — bounding with one "jump" gait spliced in (a
    bound period with a stretched second flight window).

Produces QuadReferenceData in the same record layout as the regular-gait
generator, writable via reference.generator.write_quad_reference_csv.
The stance knots' joint angles come from the generator's IK on the
model's device (`generator.ik_chain`).
"""
import copy

import numpy as np

from cafempc_tpu_torch.reference import gait as gait_mod
from cafempc_tpu_torch.reference.generator import (DEFAULT_FOOTHOLDS,
                                                   QJ_STAND, TOTAL_MASS, G,
                                                   generate_reference,
                                                   ik_chain)
from cafempc_tpu_torch.reference.quad_reference import QuadReferenceData


def projectile_z(T, t):
    """Ballistic height profile with apex h = g*T^2/8 (utils.py:16-20)."""
    h = 9.81 * T * T / 8.0
    a = -4.0 * h / (T * T)
    return a * t * (t - T)


def projectile_vz(T, t):
    h = 9.81 * T * T / 8.0
    a = -4.0 * h / (T * T)
    return a * (2 * t - T)


def generate_barrel_roll_reference(pre_stance=0.5, flight=0.45,
                                   post_stance=1.0, z_des=0.24, dt=0.01,
                                   qJ_tuck=(0.0, -1.2, 2.4), *, model):
    """In-place barrel roll: roll 0 -> 2*pi during flight on a ballistic
    CoM arc, on the whole-body model `model` (the stance IK runs on its
    device).  Returns QuadReferenceData."""
    T_total = pre_stance + flight + post_stance
    N = int(round(T_total / dt)) + 1
    qJ_tuck4 = np.tile(qJ_tuck, 4)

    recs = dict(body_state=[], qJ=[], qJd=[], foot_placements=[],
                foot_velocities=[], foot_heights=[], grf=[], torque=[],
                contact=[], status_dur=[])
    pf_stand = (np.array([0.0, 0.0, z_des]) + DEFAULT_FOOTHOLDS).copy()
    pf_stand[:, 2] = 0.0
    stance = []     # knots whose joint angles come from the IK
    for k in range(N):
        t = k * dt
        in_flight = pre_stance <= t < pre_stance + flight
        tf = t - pre_stance
        if in_flight:
            z = z_des + projectile_z(flight, tf)
            vz = projectile_vz(flight, tf)
            roll = 2.0 * np.pi * tf / flight
            rolld = 2.0 * np.pi / flight
            contact = np.zeros(4, dtype=np.int32)
            grf = np.zeros(12)
            qJ = qJ_tuck4
            sdur = np.full(4, flight)
        else:
            z = z_des
            vz = 0.0
            roll = 0.0 if t < pre_stance else 2.0 * np.pi
            rolld = 0.0
            contact = np.ones(4, dtype=np.int32)
            grf = np.zeros(12)
            grf[2::3] = TOTAL_MASS * G / 4.0
            qJ = np.zeros(12)   # from the IK below
            stance.append(k)
            sdur = np.full(4, pre_stance if t < pre_stance else post_stance)
        pos = np.array([0.0, 0.0, z])
        eul = np.array([0.0, 0.0, roll])
        vel = np.array([0.0, 0.0, vz])
        eulrate = np.array([0.0, 0.0, rolld])
        pf = pf_stand.reshape(12).copy()
        recs["body_state"].append(np.concatenate([pos, eul, vel, eulrate]))
        recs["qJ"].append(np.asarray(qJ))
        recs["qJd"].append(np.zeros(12))
        recs["foot_placements"].append(pf)
        recs["foot_velocities"].append(np.zeros(12))
        recs["foot_heights"].append(pf[2::3].copy())
        recs["grf"].append(grf)
        recs["torque"].append(np.zeros(12))
        recs["contact"].append(contact)
        recs["status_dur"].append(sdur)

    data = {k: np.asarray(v) for k, v in recs.items()}
    bs = data["body_state"][stance]
    data["qJ"][stance] = ik_chain(model, bs[:, 0:3], bs[:, 3:6],
                                  data["foot_placements"][stance], QJ_STAND)
    return QuadReferenceData(dt=dt, **data)


def generate_run_jump_reference(n_bounds_before=6, n_bounds_after=8,
                                jump_times=(0.0, 0.10, 0.20, 0.40, 0.75),
                                vx=1.0, vy=0.0, z_des=0.24,
                                swing_height=0.12, dt=0.01,
                                transition_time=2.5, *, model):
    """Running jump (gen_run_jump.py:20-48): bound approach, one bound
    period with a stretched second flight (the jump), landing stance,
    bound run-out.  CoM z stays at z_des — the MPC realizes the jump."""
    bound = gait_mod.GAITS["bound"]
    jump = copy.copy(bound)
    jump.switching_times = np.asarray(jump_times, dtype=float)
    end_gait = copy.copy(gait_mod.GAITS["stance"])
    end_gait.switching_times = np.array([0.0, 0.15])
    gaits = ([gait_mod.GAITS["stance"]]
             + [bound] * n_bounds_before
             + [jump, end_gait]
             + [bound] * n_bounds_after
             + [end_gait])
    schedule = gait_mod.build_schedule_from_gaits(gaits)
    return generate_reference(
        vx=vx, vy=vy, z_des=z_des, swing_height=swing_height, dt=dt,
        transition_time=transition_time, model=model, schedule=schedule)

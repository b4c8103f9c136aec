"""Synthetic bound-gait reference (numpy only).

Stands in for the gait CSV `Reference/Data/bound/quad_reference.csv` that
the HKD-MPC configuration reads; it is not a new capability.  It follows
the JAX package's offline generator (`reference/generator.py`), whose IK
needs the whole-body model, with two substitutions:

  * gait schedule: `gait.py` `GAITS["bound"]` + `build_mode_schedule`;
  * CoM: a velocity ramp to `vx` at constant height `z`;
  * footholds: the generator's default footholds with Raibert-style
    touchdown; swing feet: cosine blend plus a sine height bump;
  * joint angles: a closed-form planar 2-link IK on the thigh and shank
    (abad 0) in the HKD model's own leg geometry, in place of the
    whole-body Newton IK.

The result is in HKD (Cheetah-Software) leg order FR, FL, HR, HL with
`qJd` zero, as `load_quad_reference(..., reorder=True)` would return it.
`synthetic_bound_reference_urdf` returns the same gait in urdf leg order
FL, FR, HL, HR, as the MHPC cascade reads the CSV (without `reorder`).
"""
import dataclasses

import numpy as np

from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.reference import gait as gait_mod
from cafempc_tpu_torch.reference.quad_reference import (QuadReferenceData,
                                                        flip4, flip12)

# Default foothold offsets w.r.t. CoM, urdf leg order FL, FR, HL, HR
# (reference/generator.py:22-24)
DEFAULT_FOOTHOLDS = np.array([
    [0.22, 0.10, 0.0], [0.22, -0.10, 0.0],
    [-0.18, 0.10, 0.0], [-0.18, -0.10, 0.0]])
TRANSITION_TIME = 0.5    # CoM velocity ramp duration [s]
INITIAL_STANCE = 0.05    # all-feet stance before the gait starts [s]


def _com(t, vx, z):
    """CoM position and velocity on the ramp 0 -> vx over TRANSITION_TIME."""
    T = TRANSITION_TIME
    if t < T:
        return np.array([0.5 * t * t / T * vx, 0.0, z]), \
            np.array([t / T * vx, 0.0, 0.0])
    return np.array([vx * (t - 0.5 * T), 0.0, z]), np.array([vx, 0.0, 0.0])


def _swing(p0, p1, h, s):
    """Swing foot: cosine xy/z blend + sine height bump; (pos, d pos/ds)."""
    blend = 0.5 * (1.0 - np.cos(np.pi * s))
    dblend = 0.5 * np.pi * np.sin(np.pi * s)
    p = p0 + blend * (p1 - p0)
    p[2] += h * np.sin(np.pi * s)
    dp = dblend * (p1 - p0)
    dp[2] += h * np.pi * np.cos(np.pi * s)
    return p, dp


def planar_leg_ik(p_local, leg):
    """Joint angles (0, hip, knee) placing the foot of HKD leg `leg` at the
    body-frame point `p_local` in the leg's sagittal plane (abad 0, knee
    bent forward as in the default pose)."""
    x = p_local[0] - hkd.HIP_X[leg]
    zd = -p_local[2]
    c3 = (x * x + zd * zd - hkd.L2 ** 2 - hkd.L3 ** 2) \
        / (2.0 * hkd.L2 * hkd.L3)
    q3 = np.arccos(np.clip(c3, -1.0, 1.0))
    q2 = np.arctan2(x, zd) - np.arctan2(hkd.L3 * np.sin(q3),
                                        hkd.L2 + hkd.L3 * np.cos(q3))
    return np.array([0.0, q2, q3])


def synthetic_bound_reference(duration=2.0, vx=0.5, z=0.25,
                              swing_height=0.06, dt=0.01):
    """QuadReferenceData of a bound gait at speed `vx` and height `z`,
    `duration` seconds at step `dt`, in HKD leg order."""
    contacts, times = gait_mod.build_mode_schedule(
        gait_mod.GAITS["bound"], duration, INITIAL_STANCE, 0.0)
    leg_iv = [gait_mod.leg_intervals(contacts, times, l) for l in range(4)]

    # footholds per leg-mode interval (urdf order), Raibert touchdown
    footholds = []
    for l in range(4):
        iv = leg_iv[l]
        fhs = [_com(0.0, vx, z)[0] + DEFAULT_FOOTHOLDS[l]]
        for i in range(1, len(iv)):
            status, _, te = iv[i]
            if status == 0:
                stance_T = (iv[i + 1][2] - te) if i + 1 < len(iv) else 0.2
                cp, cv = _com(te, vx, z)
                off = np.minimum(cv[:2] * stance_T / 2.0, 0.2) \
                    + DEFAULT_FOOTHOLDS[l][:2]
                fhs.append(np.array([cp[0] + off[0], cp[1] + off[1], 0.0]))
            else:
                fhs.append(fhs[i - 1])
        footholds.append([np.array([f[0], f[1], 0.0]) for f in fhs])

    def leg_mode_idx(l, t):
        for i, (_, ts, te) in enumerate(leg_iv[l]):
            if ts - 1e-9 <= t < te - 1e-9:
                return i
        return len(leg_iv[l]) - 1

    n_rec = int(round(duration / dt)) + 1
    recs = {k: [] for k in ("body_state", "foot_placements",
                            "foot_velocities", "grf", "contact",
                            "status_dur")}
    for k in range(n_rec):
        t = k * dt
        c = gait_mod.contact_at(contacts, times, t)
        pos, vel = _com(t, vx, z)
        pf = np.zeros(12)
        vf = np.zeros(12)
        sdur = np.zeros(4)
        grf = np.zeros(12)
        for l in range(4):
            i = leg_mode_idx(l, t)
            status, ts, te = leg_iv[l][i]
            sdur[l] = te - ts
            if status == 1:
                pf[3 * l:3 * l + 3] = footholds[l][i]
                grf[3 * l + 2] = hkd.MASS * hkd.GRAVITY / max(c.sum(), 1)
            else:
                p0 = footholds[l][i - 1] if i > 0 else footholds[l][0]
                p1 = footholds[l][min(i + 1, len(footholds[l]) - 1)]
                span = max(te - ts, 1e-9)
                p, dp = _swing(p0, p1, swing_height, (t - ts) / span)
                pf[3 * l:3 * l + 3] = p
                vf[3 * l:3 * l + 3] = dp / span
        recs["body_state"].append(np.concatenate([pos, np.zeros(3), vel,
                                                  np.zeros(3)]))
        recs["foot_placements"].append(pf)
        recs["foot_velocities"].append(vf)
        recs["grf"].append(grf)
        recs["contact"].append(c.astype(np.int32))
        recs["status_dur"].append(sdur)
    data = {k: np.asarray(v) for k, v in recs.items()}

    # urdf (FL, FR, HL, HR) -> HKD (FR, FL, HR, HL) leg order
    for f in ("foot_placements", "foot_velocities", "grf"):
        data[f] = flip12(data[f])
    for f in ("contact", "status_dur"):
        data[f] = flip4(data[f])
    # body frame = world frame shifted to the CoM (zero Euler angles)
    p_local = (data["foot_placements"].reshape(n_rec, 4, 3)
               - data["body_state"][:, None, 0:3])
    qJ = np.stack([np.concatenate([planar_leg_ik(p_local[k, l], l)
                                   for l in range(4)])
                   for k in range(n_rec)])
    return QuadReferenceData(
        dt=dt, body_state=data["body_state"], qJ=qJ, qJd=np.zeros_like(qJ),
        foot_placements=data["foot_placements"],
        foot_velocities=data["foot_velocities"],
        foot_heights=data["foot_placements"][:, 2::3].copy(),
        grf=data["grf"], torque=np.zeros((n_rec, 12)),
        contact=data["contact"], status_dur=data["status_dur"])


def synthetic_bound_reference_urdf(duration=2.0, **kwargs):
    """`synthetic_bound_reference` put back into urdf leg order (FL, FR,
    HL, HR): the reference the MHPC cascade reads.  The leg swaps are their
    own inverse."""
    ref = synthetic_bound_reference(duration=duration, **kwargs)
    return dataclasses.replace(
        ref, qJ=flip12(ref.qJ), foot_placements=flip12(ref.foot_placements),
        foot_velocities=flip12(ref.foot_velocities), grf=flip12(ref.grf),
        torque=flip12(ref.torque), foot_heights=flip4(ref.foot_heights),
        contact=flip4(ref.contact), status_dur=flip4(ref.status_dur))

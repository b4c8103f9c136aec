# Frozen copy of cafempc_tpu_torch/reference/synthetic.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Synthetic bound-gait reference and barrel-roll settings (numpy only).

Stands in for the gait CSV `Reference/Data/bound/quad_reference.csv` that
the HKD-MPC configuration reads; it is not a new capability.  It follows
the offline generator (`reference/generator.py`: its CoM plan, default
footholds and swing curve), whose IK needs the whole-body model, with two
substitutions:

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

`write_synthetic_br_settings` and `write_synthetic_hkd_settings` write
stand-ins for the barrel-roll trajectory optimization's and the HKD-MPC's
settings files (see their docstrings).
"""
import dataclasses
import json
import os

import numpy as np

from benchmark.reference.plain.models import hkd
from benchmark.reference.plain.problems import hkd_problem as hp
from benchmark.reference.plain.problems import mhpc_problem as mp
from benchmark.reference.plain.reference import gait as gait_mod
from benchmark.reference.plain.reference.generator import (DEFAULT_FOOTHOLDS, CoMPlan,
                                                   _swing_interp)
from benchmark.reference.plain.reference.quad_reference import (QuadReferenceData,
                                                        flip4, flip12)
from benchmark.reference.plain.solver.options import SolverOptions

TRANSITION_TIME = 0.5    # CoM velocity ramp duration [s]
INITIAL_STANCE = 0.05    # all-feet stance before the gait starts [s]


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
    com = CoMPlan([0.0, 0.0, z], [vx, 0.0], z, TRANSITION_TIME)

    # footholds per leg-mode interval (urdf order), Raibert touchdown
    footholds = []
    for l in range(4):
        iv = leg_iv[l]
        fhs = [com.pos(0.0) + DEFAULT_FOOTHOLDS[l]]
        for i in range(1, len(iv)):
            status, _, te = iv[i]
            if status == 0:
                stance_T = (iv[i + 1][2] - te) if i + 1 < len(iv) else 0.2
                cp, cv = com.pos(te), com.vel(te)
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
        pos, vel = com.pos(t), com.vel(t)
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
                p, dp = _swing_interp(p0, p1, swing_height,
                                      (t - ts) / span)
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


# ReB blocks of the synthetic barrel-roll settings: (delta, delta_min, eps)
BR_REB = {"Torque": (0.1, 0.1, 0.1), "JointVel": (0.1, 0.1, 0.1),
          "Joint": (0.1, 0.1, 0.1), "MinHeight": (0.1, 0.1, 0.1),
          "GRF": (0.1, 0.1, 0.3)}
# TD_AL: the barrel-roll loader's own fallbacks (barrel_roll.py:237-240)
BR_TD_AL = {"lambda": 0.0, "sigma": 20.0, "sigma_max": 1e4}


def write_synthetic_br_settings(setting_dir):
    """Write a stand-in for the reference's barrel-roll settings directory
    (MHPC/MHPC-Trajopt/BarrelRoll/setting, absent from the repository)
    into `setting_dir`: `br_cost_weights.JSON`, `br_constraint_params.info`
    and `br_ddp_setting.info`, in the formats that
    `problems/barrel_roll.py` and `solver/options.py` parse.  Returns
    `setting_dir`.

    They are not the robot's settings, and results on them are not the
    reference's: every phase takes the MHPC whole-body constructor
    defaults for q / r / qf (`mhpc_problem._default_weights`,
    MHPCCost.h:12-38), the ReB blocks BR_REB, the touchdown AL BR_TD_AL,
    and the ddp block the `SolverOptions()` defaults.  With the
    reference's files in place of these, the same code runs on them."""
    os.makedirs(setting_dir, exist_ok=True)
    cfg = mp._default_weights(mp.MHPCConfig())
    q, qf = cfg.wb_q, cfg.wb_qf
    phase = dict(qw_qB=q[0:6], qw_qJ=q[6:9], qw_vB=q[18:24],
                 qw_vJ=q[24:27], rw=float(cfg.wb_r[0]), qfw_qB=qf[0:6],
                 qfw_qJ=qf[6:9], qfw_vB=qf[18:24], qfw_vJ=qf[24:27])
    phase = {k: v if isinstance(v, float) else [float(x) for x in v]
             for k, v in phase.items()}
    with open(os.path.join(setting_dir, "br_cost_weights.JSON"), "w") as fh:
        json.dump({f"cost_phase_{i + 1}": phase for i in range(6)}, fh,
                  indent=2)

    with open(os.path.join(setting_dir, "br_constraint_params.info"),
              "w") as fh:
        for name, (delta, delta_min, eps) in BR_REB.items():
            fh.write(_info_block(f"{name}_ReB", dict(
                delta=delta, delta_min=delta_min, eps=eps)))
        fh.write(_info_block("TD_AL", BR_TD_AL))
    with open(os.path.join(setting_dir, "br_ddp_setting.info"), "w") as fh:
        fh.write(_ddp_block())
    return setting_dir


def _info_block(name, kv):
    """One block of a boost property-tree .info file."""
    return f"{name}\n{{\n" + "".join(
        f"    {k} {str(v).lower() if isinstance(v, bool) else repr(v)}\n"
        for k, v in kv.items()) + "}\n"


def _ddp_block():
    """The `ddp` block of a ddp_setting.info with the `SolverOptions()`
    defaults of the reference struct's fields."""
    opts = SolverOptions()
    return _info_block("ddp", {
        f.name: getattr(opts, f.name)
        for f in dataclasses.fields(SolverOptions)
        if f.name not in ("ls_eps_min", "reg_max", "reg_min_init")})


def write_synthetic_hkd_settings(root):
    """Write a stand-in for the reference's HKD-MPC settings under `root`,
    laid out like the reference tree: HKDMPC/settings/constraint_params.info
    (the `GRF_ReB` and `TD_AL` blocks) and HKDMPC/settings/ddp_setting.info
    (the `ddp` block), in the formats that
    `hkd_problem.load_hkd_constraint_params` and
    `solver/options.load_solver_options` parse.  Returns `root`.

    They are not the robot's settings: the values are the in-code defaults
    of `HKDConfig()` and `SolverOptions()`, so a solve on them is the solve
    on those defaults.  With the reference's files in place of these, the
    same code runs on them."""
    d = os.path.join(root, "HKDMPC", "settings")
    os.makedirs(d, exist_ok=True)
    cfg = hp.HKDConfig()
    with open(os.path.join(d, "constraint_params.info"), "w") as fh:
        fh.write(_info_block("GRF_ReB", dict(
            delta=cfg.grf_reb_delta, delta_min=cfg.grf_reb_delta_min,
            eps=cfg.grf_reb_eps)))
        fh.write(_info_block("TD_AL", dict(
            sigma=cfg.td_al_sigma, sigma_max=cfg.td_al_sigma_max,
            **{"lambda": cfg.td_al_lambda})))
    with open(os.path.join(d, "ddp_setting.info"), "w") as fh:
        fh.write(_ddp_block())
    return root

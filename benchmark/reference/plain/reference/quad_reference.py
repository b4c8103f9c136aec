# Frozen copy of cafempc_tpu_torch/reference/quad_reference.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Quadruped reference-trajectory management (numpy only; counterpart of
`cafempc_tpu/reference/quad_reference.py`: the HKD, WB and SRB queries).

Loads the keyed-line `quad_reference.csv` format of the reference stack
(QuadReference.cpp:134-356) into a struct-of-arrays numpy store, and
provides the sliding-window / time-query API the plan builder consumes
(QuadReference.h:159-207).

Body-state layout conventions:
  on file:       [eul, pos, eulrate, vel]
  in memory:     [pos, eul, vel, eulrate]     (QuadReference.cpp:358-371)
Leg-dependent quantities ship in urdf leg order (FL, FR, HL, HR).
reorder=True flips left<->right legs to the Cheetah-Software order
(FR, FL, HR, HL) used by HKD-MPC (HKDMPC.h:32) and zeroes qJd
(QuadReference.cpp:373-408).
"""
import dataclasses

import numpy as np


@dataclasses.dataclass
class QuadReferenceData:
    """Struct-of-arrays top-level reference data."""
    dt: float
    body_state: np.ndarray       # [T, 12]  [pos, eul, vel, eulrate]
    qJ: np.ndarray               # [T, 12]
    qJd: np.ndarray              # [T, 12]
    foot_placements: np.ndarray  # [T, 12]
    foot_velocities: np.ndarray  # [T, 12]
    foot_heights: np.ndarray     # [T, 4]
    grf: np.ndarray              # [T, 12]
    torque: np.ndarray           # [T, 12]
    contact: np.ndarray          # [T, 4] int
    status_dur: np.ndarray       # [T, 4]

    def __len__(self):
        return self.body_state.shape[0]


_KEY_TO_FIELD = {
    "body_state": "body_state", "jnt_angle": "qJ", "jnt_vel": "qJd",
    "torque": "torque", "foot_placements": "foot_placements",
    "foot_velocities": "foot_velocities", "foot_height": "foot_heights",
    "grf": "grf", "contact": "contact", "status_dur": "status_dur",
}


def flip12(a):
    """Swap left<->right leg triples: [0:3]<->[3:6], [6:9]<->[9:12]."""
    return a[..., [3, 4, 5, 0, 1, 2, 9, 10, 11, 6, 7, 8]]


def flip4(a):
    """Swap left<->right legs of a per-leg [..., 4] array."""
    return a[..., [1, 0, 3, 2]]


def load_quad_reference(fname, reorder=False):
    """Parse quad_reference.csv (QuadReference::load_top_level_data,
    QuadReference.cpp:134-408).  `reorder=True` flips legs to the
    Cheetah-Software order used by HKD and zeroes qJd."""
    records = {v: [] for v in _KEY_TO_FIELD.values()}
    dt = None
    cur = {v: None for v in _KEY_TO_FIELD.values()}
    with open(fname) as fh:
        lines = iter(fh.read().splitlines())
    for line in lines:
        key = line.strip()
        if key == "dt":
            dt = float(next(lines))
            continue
        matched = next((f for k, f in _KEY_TO_FIELD.items() if k in key),
                       None)
        if matched is None:
            continue
        cur[matched] = np.array(next(lines).split(), dtype=float)
        if matched == "status_dur":
            # status_dur terminates a record (QuadReference.cpp:325-339)
            for fld, v in cur.items():
                records[fld].append(v if v is not None else np.zeros(12))
            cur = {v: None for v in _KEY_TO_FIELD.values()}
    data = {f: np.asarray(records[f]) for f in records}

    bs = data["body_state"]
    data["body_state"] = np.concatenate(
        [bs[:, 3:6], bs[:, 0:3], bs[:, 9:12], bs[:, 6:9]], axis=1)
    if reorder:
        for f in ("qJ", "foot_placements", "foot_velocities", "grf",
                  "torque"):
            data[f] = flip12(data[f])
        data["qJd"] = np.zeros_like(data["qJd"])
        data["contact"] = flip4(data["contact"])
        data["status_dur"] = flip4(data["status_dur"])
    data["contact"] = data["contact"].astype(np.int32)
    return QuadReferenceData(dt=dt, **data)


class QuadReference:
    """Sliding-window view over the top-level data with time queries
    (QuadReference.cpp): a window of `plan_dur/dt + 1` records starting at
    `k_cur`; `step(dt_sim)` advances; queries are relative to the window
    start with half-step rounding and end-clamping."""

    def __init__(self, top: QuadReferenceData):
        self.tp = top
        self.dt = top.dt
        self.k_cur = 0
        self.t_cur = 0.0
        self.sz = 0
        self.dur = 0.0

    def initialize(self, plan_dur):
        self.k_cur = 0
        self.t_cur = 0.0
        self.dur = plan_dur
        self.sz = int(round(plan_dur / self.dt)) + 1

    def step(self, dt_sim):
        n = int(round(dt_sim / self.dt))
        for _ in range(max(n, 1) if dt_sim >= self.dt - 1e-9 else 0):
            self.k_cur += 1
            self.t_cur += self.dt
            if self.k_cur + self.sz + 1 >= len(self.tp):
                raise IndexError("Out of scope of the top-level data")

    def get_start_time(self):
        return self.t_cur

    def get_end_time(self):
        return self.t_cur + self.dur

    def _k(self, t):
        k = int(np.floor(t / self.dt + 1e-9))
        if t - k * self.dt > 0.5 * self.dt:
            k += 1
        if k >= self.sz:
            k = self.sz - 1
        return self.k_cur + k

    def at_t(self, t, field):
        """Query one field at window-relative time t."""
        return getattr(self.tp, field)[self._k(t)]

    def contact_at_t(self, t):
        return self.tp.contact[self._k(t)]

    def contact_duration_at_t(self, t):
        return self.tp.status_dur[self._k(t)]

    def record_at_t(self, t):
        k = self._k(t)
        return {f: getattr(self.tp, f)[k] for f in (
            "body_state", "qJ", "qJd", "foot_placements", "foot_velocities",
            "foot_heights", "grf", "torque", "contact", "status_dur")}


def hkd_state_ref_at(quad_ref: QuadReference, t):
    """HKD 24-dim state reference (HKDReference.cpp:24-62):
    [eul, pos, eulrate, vel, qdummy], where qdummy is the foot placement of
    a stance leg and qJ of a swing leg."""
    r = quad_ref.record_at_t(t)
    bs = r["body_state"]
    x = np.zeros(24)
    x[0:3] = bs[3:6]
    x[3:6] = bs[0:3]
    x[6:9] = bs[9:12]
    x[9:12] = bs[6:9]
    for leg in range(4):
        src = r["foot_placements"] if r["contact"][leg] > 0 else r["qJ"]
        x[12 + 3 * leg:15 + 3 * leg] = src[3 * leg:3 * leg + 3]
    return x


def hkd_control_ref_at(quad_ref: QuadReference, t):
    """[grf, qJd] control reference (HKDReference.cpp:8-17)."""
    r = quad_ref.record_at_t(t)
    return np.concatenate([r["grf"], r["qJd"]])


def wb_state_ref_at(quad_ref: QuadReference, t):
    """WB 36-dim state reference [pos, eul, qJ, vel, eulrate, qJd]
    (MHPCReference.cpp:25-42)."""
    r = quad_ref.record_at_t(t)
    bs = r["body_state"]
    return np.concatenate([bs[0:6], r["qJ"], bs[6:12], r["qJd"]])


def srb_state_ref_at(quad_ref: QuadReference, t):
    """SRB 12-dim state reference = body_state (MHPCReference.cpp:63-77)."""
    return quad_ref.record_at_t(t)["body_state"].copy()

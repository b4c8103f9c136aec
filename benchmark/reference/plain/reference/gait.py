# Frozen copy of cafempc_tpu_torch/reference/gait.py, the port's plain path, for the
# benchmark's reference: imports point into benchmark/reference/plain.
"""Gait schedules (numpy only; counterpart of `cafempc_tpu/reference/gait.py`).

Mode sequences and switching times of the offline reference generator
(scripts/Reference_python/gait_schedule.py:17-46), and mode -> stance legs
in urdf leg order FL, FR, HL, HR (quad_mode_definition.py).
"""
import dataclasses

import numpy as np

QUAD_MODES = {
    "Fly": [0, 0, 0, 0],
    "FL": [1, 0, 0, 0], "FR": [0, 1, 0, 0],
    "HL": [0, 0, 1, 0], "HR": [0, 0, 0, 1],
    "FR-FL": [1, 1, 0, 0], "FR-HR": [0, 1, 0, 1], "FR-HL": [0, 1, 1, 0],
    "FL-HL": [1, 0, 1, 0], "FL-HR": [1, 0, 0, 1], "HR-HL": [0, 0, 1, 1],
    "FL-HR-HL": [1, 0, 1, 1], "FR-HR-HL": [0, 1, 1, 1],
    "FR-FL-HL": [1, 1, 1, 0], "FR-FL-HR": [1, 1, 0, 1],
    "Stance": [1, 1, 1, 1],
}


@dataclasses.dataclass
class PeriodicGait:
    name: str
    modes: list                 # mode-name strings
    switching_times: np.ndarray  # len(modes) + 1, one period

    @property
    def period(self):
        return self.switching_times[-1]


GAITS = {
    "stance": PeriodicGait("stance", ["Stance"], np.array([0.0, 0.05])),
    "trot": PeriodicGait("trot", ["FL-HR", "FR-HL"],
                         np.array([0.0, 0.25, 0.5])),
    "flytrot": PeriodicGait("flytrot", ["FL-HR", "Fly", "FR-HL", "Fly"],
                            np.array([0.0, 0.15, 0.25, 0.4, 0.5])),
    "bound": PeriodicGait("bound", ["HR-HL", "Fly", "FR-FL", "Fly"],
                          np.array([0.0, 0.1, 0.2, 0.3, 0.4])),
    "pace": PeriodicGait("pace", ["FL-HL", "FR-HR"],
                         np.array([0.0, 0.25, 0.5])),
    "flypace": PeriodicGait("flypace", ["FL-HL", "Fly", "FR-HR", "Fly"],
                            np.array([0.0, 0.15, 0.25, 0.4, 0.5])),
    "pronk": PeriodicGait("pronk", ["Stance", "Fly"],
                          np.array([0.0, 0.1, 0.3])),
}


def build_mode_schedule(gait: PeriodicGait, final_time,
                        initial_stance=0.05, end_stance=0.0):
    """Initial stance + periodic repetition (+ optional end stance)
    (GaitSchedule.buildModeSchedule_, gait_schedule.py:105-128).

    Returns (contacts [n_modes, 4], switching_times [n_modes + 1]).
    """
    contacts = [np.array(QUAD_MODES["Stance"])]
    times = [0.0, initial_stance]
    while times[-1] < final_time - 1e-9:
        t_end = times[-1]
        for i, m in enumerate(gait.modes):
            contacts.append(np.array(QUAD_MODES[m]))
            t_sw = min(t_end + gait.switching_times[i + 1], final_time)
            times.append(t_sw)
            if t_sw >= final_time - 1e-9:
                break
    if end_stance > 0:
        contacts.append(np.array(QUAD_MODES["Stance"]))
        times.append(times[-1] + end_stance)
    return np.stack(contacts), np.asarray(times)


def build_schedule_from_gaits(gaits, initial_stance=0.0):
    """Concatenate one period of each listed gait into a single mode
    schedule, mirroring GaitSchedule.addOneGait composition
    (gait_schedule.py:48-70; used by gen_run_jump.py:30-48 to splice a
    stretched-flight "jump" gait into a bound sequence).

    Returns (contacts [n_modes, 4], switching_times [n_modes + 1]).
    """
    contacts = []
    times = [0.0]
    if initial_stance > 0:
        contacts.append(np.array(QUAD_MODES["Stance"]))
        times.append(initial_stance)
    for g in gaits:
        for i, m in enumerate(g.modes):
            contacts.append(np.array(QUAD_MODES[m]))
            times.append(times[-1] + (g.switching_times[i + 1]
                                      - g.switching_times[i]))
    return np.stack(contacts), np.asarray(times)


def contact_at(contacts, times, t):
    i = np.searchsorted(times, t + 1e-9) - 1
    i = min(max(i, 0), len(contacts) - 1)
    return contacts[i]


def leg_intervals(contacts, times, leg):
    """Per-leg merged (status, start, end) intervals."""
    out = []
    for i, c in enumerate(contacts):
        s = int(c[leg])
        if out and out[-1][0] == s:
            out[-1] = (s, out[-1][1], times[i + 1])
        else:
            out.append((s, times[i], times[i + 1]))
    return out

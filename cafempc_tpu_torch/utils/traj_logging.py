"""Trajectory logging in the reference's text format (numpy only; the
port's copy of `cafempc_tpu/utils/traj_logging.py`, writing the same
bytes).

Mirror of log_trajectory_sequence (HSDDPSolver/common/HSDDP_Utils.h:81-142):
four files — state_log.txt, control_log.txt, cost_log.txt,
value_grad_log.txt — one comma-separated row per knot, phases
concatenated; per phase the rows are Xbar[0..h], Ubar[0..h-1] plus a
repeat of the last control, running costs plus the terminal cost, and the
value gradient G.
"""
import os

import numpy as np


def _fmt(v):
    return ",".join(f"{x:.5g}" for x in np.asarray(v).ravel())


def log_trajectory_sequence(folder, state, plan_np):
    """Write the four log files from one scenario's SolverState /
    SolveResult in numpy (e.g. `convert.scenario(convert.to_numpy(s), 0)`)
    + host plan.

    The flat plan is split back into phases at reset steps so the row
    layout matches the reference's per-phase dump.
    """
    os.makedirs(folder, exist_ok=True)
    Xbar = np.asarray(state.traj.Xbar) if hasattr(state, "traj") \
        else np.asarray(state.Xbar)
    Ubar = np.asarray(state.traj.Ubar) if hasattr(state, "traj") \
        else np.asarray(state.Ubar)
    G = np.asarray(state.traj.G) if hasattr(state, "traj") else None
    active = np.asarray(plan_np.step.active)
    is_reset = np.asarray(plan_np.step.is_reset)
    n_steps = len(active)

    # phase boundaries: knot ranges [start, end] separated by reset steps
    phases = []
    start = 0
    for k in range(n_steps):
        if active[k] == 0:
            phases.append((start, k))
            start = None
            break
        if is_reset[k]:
            phases.append((start, k))
            start = k + 1
    if start is not None:
        last = int(np.where(active > 0)[0][-1]) + 1 if active.any() else 0
        phases.append((start, last))

    with open(os.path.join(folder, "state_log.txt"), "w") as fs, \
            open(os.path.join(folder, "control_log.txt"), "w") as fc, \
            open(os.path.join(folder, "cost_log.txt"), "w") as fl, \
            open(os.path.join(folder, "value_grad_log.txt"), "w") as fg:
        for (s, e) in phases:
            if e <= s:
                continue
            for k in range(s, e):
                fc.write(_fmt(Ubar[k]) + "\n")
                fs.write(_fmt(Xbar[k]) + "\n")
                if G is not None:
                    fg.write(_fmt(G[k]) + "\n")
            fc.write(_fmt(Ubar[e - 1]) + "\n")
            fs.write(_fmt(Xbar[e]) + "\n")
            if G is not None:
                fg.write(_fmt(G[e]) + "\n")
        n = int(state.info.n_entries)
        for c in np.asarray(state.info.cost_buf[:n]):
            fl.write(f"{c:.5g}\n")


def load_log(folder, name="state_log.txt"):
    rows = []
    with open(os.path.join(folder, name)) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(np.fromstring(line, sep=","))
    return np.asarray(rows)

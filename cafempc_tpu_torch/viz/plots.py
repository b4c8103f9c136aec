"""Trajectory visualization (port of `cafempc_tpu/viz/plots.py`).

Replaces the reference's PyBullet/LCM visualization scripts
(scripts/Visualization/) with matplotlib renderings that need no
simulator: gait charts, body trajectories, solver convergence, and a
stick-figure side view of the whole-body plan.  Also publishes the
reference's `visualize_wb_traj` channel, so that external animators keep
working (utils.publish_trajectory_lcm analogue).

matplotlib is imported only when a plot is drawn.  The stick figure takes
the whole-body model (`wbm.load_model`) from the caller and runs its FK
through `models/rbda.py` on the model's device; the JAX module loads the
default URDF when no model is given.
"""
import numpy as np
import torch

from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.models import rbda

TRUNK_HALF = 0.19       # m, the trunk segment drawn either side of its origin


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_gait_schedule(contacts, dt, path, leg_names=("FL", "FR", "HL",
                                                      "HR")):
    """Contact-schedule bar chart (utils.plot_gait_schedule analogue)."""
    plt = _mpl()
    contacts = np.asarray(contacts)
    T = contacts.shape[0]
    fig, ax = plt.subplots(figsize=(8, 2.5))
    for leg in range(4):
        on = contacts[:, leg] > 0
        t = np.arange(T) * dt
        ax.broken_barh(
            [(t[s], dt * (e - s)) for s, e in _runs(on)],
            (3 - leg - 0.4, 0.8))
    ax.set_yticks([3, 2, 1, 0])
    ax.set_yticklabels(leg_names)
    ax.set_xlabel("time (s)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _runs(mask):
    """(start, end) index pairs of the runs of True in mask."""
    out = []
    s = None
    for i, m in enumerate(mask):
        if m and s is None:
            s = i
        if not m and s is not None:
            out.append((s, i))
            s = None
    if s is not None:
        out.append((s, len(mask)))
    return out


def plot_solve_convergence(info, path):
    """Cost / feasibility / constraint-violation iteration curves from a
    SolverInfo of one scenario (host arrays or tensors)."""
    plt = _mpl()
    n = int(info.n_entries)
    fig, axs = plt.subplots(1, 3, figsize=(12, 3))
    for ax, buf, title in zip(axs, (info.cost_buf, info.dyn_feas_buf,
                                    info.eqn_feas_buf),
                              ("cost", "dynamics infeasibility",
                               "terminal-constraint violation")):
        ax.semilogy(np.maximum(np.asarray(buf[:n]), 1e-12))
        ax.set_title(title)
        ax.set_xlabel("iteration")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_body_trajectory(Xbar, knot_active, path, body_slice=slice(0, 6),
                         labels=("x", "y", "z", "yaw", "pitch", "roll")):
    plt = _mpl()
    X = np.asarray(Xbar)[np.asarray(knot_active) > 0]
    fig, axs = plt.subplots(2, 3, figsize=(12, 5))
    for i in range(6):
        ax = axs[i // 3, i % 3]
        ax.plot(X[:, body_slice][:, i])
        ax.set_title(labels[i])
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def leg_bodies(model):
    """(trunk, [(hip, knee) per leg]) body indices of the stick figure:
    the knee carries the foot frame, its grandparent is the hip (the
    abduction joint), whose parent is the trunk (bodies 5, 6 + 3 leg and
    8 + 3 leg of the JAX module on the Mini Cheetah tree)."""
    legs = []
    for knee in model.frame_dof:
        hip = model.parent[model.parent[knee]]
        legs.append((hip, knee))
    return model.parent[legs[0][0]], legs


def stick_segments(model, X):
    """Stick-figure segments of whole-body states X [n, >= 18] (numpy):
    [n, 9, 2, 3], the trunk (TRUNK_HALF either side of its origin along its
    x axis), then each leg's hip -> knee and knee -> foot, in world
    coordinates; one FK of all n states on the model's device."""
    q = torch.as_tensor(np.asarray(X, dtype=np.float64)[:, :18],
                        dtype=model.mass.dtype, device=model.mass.device)
    R, p, _ = rbda.fk(model, q)
    feet = rbda._foot_points(model, R, p).cpu().numpy()
    R, p = R.cpu().numpy(), p.cpu().numpy()
    trunk, legs = leg_bodies(model)
    half = R[:, trunk] @ np.array([TRUNK_HALF, 0.0, 0.0])
    segs = [np.stack([p[:, trunk] - half, p[:, trunk] + half], 1)]
    for leg, (hip, knee) in enumerate(legs):
        segs.append(np.stack([p[:, hip], p[:, knee]], 1))
        segs.append(np.stack([p[:, knee], feet[:, leg]], 1))
    return np.stack(segs, 1)


def plot_wb_stickfigure(model, Xbar, knot_active, path, stride=4,
                        plane=(1, 2)):
    """Side-view stick figure of a whole-body plan: the trunk segment and
    the legs drawn hip -> knee -> foot at every `stride`-th active knot
    (visualize_motion.py stand-in).  `model`: the whole-body model."""
    plt = _mpl()
    X = np.asarray(Xbar)[np.asarray(knot_active) > 0][::stride]
    segs = stick_segments(model, X)
    fig, ax = plt.subplots(figsize=(10, 4))
    a, b = plane
    for s in segs:
        ax.plot(s[0, :, a], s[0, :, b], "k-", lw=2, alpha=0.6)
        for leg in range(4):
            hip, knee, foot = s[1 + 2 * leg, 0], s[1 + 2 * leg, 1], \
                s[2 + 2 * leg, 1]
            ax.plot([hip[a], knee[a], foot[a]], [hip[b], knee[b], foot[b]],
                    "-", lw=1, alpha=0.5)
    ax.set_aspect("equal")
    ax.axhline(0.0, color="gray", lw=0.5)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def publish_wb_traj(endpoint, Xbar, knot_active, dt, contacts=None,
                    channel="visualize_wb_traj"):
    """Publish the active knots of a whole-body plan as wbTraj_lcmt for
    external animators (utils.publish_trajectory_lcm analogue);
    `endpoint`: a `comms.udpm.LCMEndpoint`."""
    X = np.asarray(Xbar)[np.asarray(knot_active) > 0]
    sz = X.shape[0]
    msg = w.wbTraj_lcmt(sz=sz, wb_sz=sz)
    msg.time = np.arange(sz) * dt
    msg.pos = X[:, 0:3]
    msg.eul = X[:, 3:6]
    msg.qJ = X[:, 6:18]
    msg.vWorld = X[:, 18:21]
    msg.eulrate = X[:, 21:24]
    msg.qJd = X[:, 24:36]
    msg.torque = np.zeros((sz, 12))
    msg.defect = np.zeros(sz)
    msg.hg = np.zeros((sz, 3))
    msg.dhg = np.zeros((sz, 3))
    msg.contact = np.zeros((sz, 4), dtype=np.int32) if contacts is None \
        else np.asarray(contacts)[:sz].astype(np.int32)
    endpoint.publish(channel, msg)

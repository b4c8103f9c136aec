"""The port's visualization (`cafempc_tpu_torch/viz/`) and HKD-MPC demo
(`cafempc_tpu_torch/examples/hkd_mpc_demo.py`) on the CPU: the JAX
package's tests/test_viz.py cases on the port (the stick figure with the
synthetic quadruped, since the port takes the model), the stick figure's
and the animator's segment endpoints against the JAX `rbda.fk` points on
the same URDF (1e-12), `publish_wb_traj`'s bytes against the JAX
function's, the animator's GIF, frame strip and LCM service, and the demo's
closed loop for 2 MPC steps."""
import os

import jax.numpy as jnp
import matplotlib.animation as manim
import numpy as np
import pytest
import torch

from cafempc_tpu.models import rbda as jrbda
from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu.viz import plots as jplots
from cafempc_tpu_torch.comms import lcm_wire as w
from cafempc_tpu_torch.comms.udpm import LCMEndpoint
from cafempc_tpu_torch.examples import hkd_mpc_demo as demo
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
from cafempc_tpu_torch.viz import animator, plots


class _FakeInfo:
    n_entries = 5
    cost_buf = np.array([10.0, 5.0, 2.0, 1.0, 0.5, 0, 0])
    dyn_feas_buf = np.array([1.0, 0.1, 0.01, 1e-3, 1e-4, 0, 0])
    eqn_feas_buf = np.array([0.1, 0.05, 0.01, 1e-3, 1e-4, 0, 0])


class _Captured:
    """An endpoint that keeps what it is asked to publish."""

    def __init__(self):
        self.sent = []

    def publish(self, channel, msg):
        self.sent.append((channel, msg))


class _MemTransport:
    """The four-method transport of `LCMEndpoint`, in memory."""

    def __init__(self):
        self.queue, self.handlers = [], {}

    def publish(self, channel, data):
        self.queue.append((channel, bytes(data)))

    def subscribe(self, channel, handler):
        self.handlers.setdefault(channel, []).append(handler)

    def handle(self, timeout=0.1):
        if not self.queue:
            return False
        channel, data = self.queue.pop(0)
        for h in self.handlers.get(channel, []):
            h(channel, data)
        return True

    def close(self):
        pass


@pytest.fixture(scope="module")
def urdf_path(tmp_path_factory):
    return synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))


@pytest.fixture(scope="module")
def model(urdf_path):
    return wbm.load_model(urdf_path, "cpu", torch.float64)


def _stance_states(n=8):
    """The JAX test_viz stick-figure states: standing joints, z 0.3, y
    sweeping 0 -> 0.5, plus seeded orientations and joint offsets."""
    X = np.zeros((n, 36))
    X[:, 2] = 0.3
    X[:, 6:18] = np.tile([0.0, -0.8, 1.6], 4)
    X[:, 1] = np.linspace(0, 0.5, n)
    rng = np.random.default_rng(4)
    X[:, 3:6] += rng.normal(0, 0.3, (n, 3))
    X[:, 6:18] += rng.normal(0, 0.2, (n, 12))
    return X


def test_gait_schedule_plot(tmp_path):
    contacts = np.array([[1, 1, 1, 1]] * 5 + [[1, 0, 0, 1]] * 5
                        + [[0, 1, 1, 0]] * 5)
    p = str(tmp_path / "gait.png")
    plots.plot_gait_schedule(contacts, 0.01, p)
    assert os.path.getsize(p) > 1000


def test_convergence_plot(tmp_path):
    p = str(tmp_path / "conv.png")
    plots.plot_solve_convergence(_FakeInfo(), p)
    assert os.path.getsize(p) > 1000


def test_body_trajectory_plot(tmp_path):
    X = np.random.default_rng(0).normal(size=(20, 36))
    p = str(tmp_path / "body.png")
    plots.plot_body_trajectory(X, np.ones(20), p)
    assert os.path.getsize(p) > 1000


def test_stickfigure_plot(tmp_path, model):
    X = np.zeros((8, 36))
    X[:, 2] = 0.3
    X[:, 6:18] = np.tile([0.0, -0.8, 1.6], 4)
    X[:, 1] = np.linspace(0, 0.5, 8)
    p = str(tmp_path / "stick.png")
    plots.plot_wb_stickfigure(model, X, np.ones(8), p, stride=2)
    assert os.path.getsize(p) > 1000


def test_leg_bodies_are_the_jax_modules(model):
    """The bodies the stick figure reads from the tree are the JAX
    module's fixed indices on the synthetic quadruped: trunk 5, hips
    6 + 3 leg, knees 8 + 3 leg."""
    trunk, legs = plots.leg_bodies(model)
    assert trunk == 5
    assert legs == [(6 + 3 * leg, 8 + 3 * leg) for leg in range(4)]


def _jax_segments(jmodel, x):
    """The JAX stick figure's / animator's segments of one state: trunk,
    then hip -> knee and knee -> foot per leg (plots.py:96-108,
    animator.py:38-52)."""
    q = jnp.asarray(x[:18])
    R, p, _ = jrbda.fk(jmodel, q)
    p, R5 = np.asarray(p), np.asarray(R[5])
    feet = np.asarray(jrbda.foot_kinematics(jmodel, q))
    segs = [(p[5] + R5 @ np.array([-0.19, 0, 0]),
             p[5] + R5 @ np.array([0.19, 0, 0]))]
    for leg in range(4):
        segs.append((p[6 + 3 * leg], p[8 + 3 * leg]))
        segs.append((p[8 + 3 * leg], feet[leg]))
    return np.asarray(segs)


def test_segments_match_jax_fk(model, urdf_path, tmp_path):
    """Both the stick figure's and the animator's endpoints."""
    jmodel = jwbm.load_model(urdf_path)
    X = _stance_states()
    want = np.stack([_jax_segments(jmodel, x) for x in X])
    got = plots.stick_segments(model, X)
    anim = animator.WBTrajAnimator(model, out_dir=str(tmp_path))
    got_anim = anim._frame_segments(X[:, :18])
    assert got.shape == want.shape == (8, 9, 2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_anim, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("with_contacts", [False, True])
def test_publish_wb_traj_bytes_match_jax(with_contacts):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(12, 36))
    act = (np.arange(12) < 9).astype(float)
    contacts = rng.integers(0, 2, (12, 4)) if with_contacts else None
    got, want = _Captured(), _Captured()
    plots.publish_wb_traj(got, X, act, 0.01, contacts)
    jplots.publish_wb_traj(want, X, act, 0.01, contacts)
    assert [c for c, _ in got.sent] == [c for c, _ in want.sent] \
        == ["visualize_wb_traj"]
    assert got.sent[0][1].encode() == want.sent[0][1].encode()


def test_animator_renders_and_serves(model, tmp_path, monkeypatch):
    """A published trajectory served to the animator over an endpoint
    becomes a GIF; without the Pillow writer a frame strip; an error of
    the writer itself propagates (the JAX animator writes the strip on any
    error)."""
    ep = LCMEndpoint(_MemTransport())
    anim = animator.WBTrajAnimator(model, out_dir=str(tmp_path))
    plots.publish_wb_traj(ep, _stance_states(6), np.ones(6), 0.02)
    paths = anim.serve(ep, max_msgs=1, timeout=5.0)
    assert len(paths) == 1 and paths[0].endswith(".gif")
    assert os.path.getsize(paths[0]) > 1000
    cap = _Captured()
    plots.publish_wb_traj(cap, _stance_states(6), np.ones(6), 0.02)
    msg = w.wbTraj_lcmt.decode(cap.sent[0][1].encode())
    monkeypatch.setattr(manim.writers, "is_available", lambda name: False)
    strip = anim.render(msg, name="strip")
    assert strip.endswith("strip.png") and os.path.getsize(strip) > 1000
    monkeypatch.undo()

    def broken(*a, **k):
        raise RuntimeError("writer failed")
    monkeypatch.setattr(manim, "PillowWriter", broken)
    with pytest.raises(RuntimeError, match="writer failed"):
        anim.render(msg, name="broken")


def test_demo_closed_loop_two_steps(tmp_path):
    """The demo's loop on the CPU for 2 MPC steps on the synthetic bound:
    finite costs, the height within the demo's range, the states' shape."""
    cfg = hp.HKDConfig()
    qr = QuadReference(demo.reference("bound", None, str(tmp_path), "cpu",
                                      2.0))
    qr.initialize(cfg.plan_duration)
    rt = HKDMPCRuntime(qr, cfg, demo.OPTS, device="cpu")
    seen = []
    X, tape = demo.closed_loop(rt, demo.initial_state(qr, "cpu"), 2,
                               lambda i, x, t: seen.append(
                                   float(t.solve_info["cost"][-1])))
    assert X.shape == (3, 24) and len(seen) == 2
    assert np.isfinite(seen).all() and np.isfinite(X).all()
    assert all(demo.Z_RANGE[0] < z < demo.Z_RANGE[1] for z in X[:, 5])
    assert rt.mpc_time == pytest.approx(2 * rt.dt_mpc)

"""The port's numpy host modules (gait schedules, reference loading and
queries, warm start) against the JAX package's, on the same inputs:
results must be identical."""
import numpy as np
import pytest

from cafempc_tpu.problems import hkd_problem as jhp
from cafempc_tpu.reference import gait as jgait
from cafempc_tpu.reference import quad_reference as jqr
from cafempc_tpu.runtime import warm_start as jws
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference import gait
from cafempc_tpu_torch.reference import quad_reference as qr
from cafempc_tpu_torch.reference.synthetic import synthetic_bound_reference
from cafempc_tpu_torch.runtime import warm_start as ws

FIELDS = ("body_state", "qJ", "qJd", "foot_placements", "foot_velocities",
          "foot_heights", "grf", "torque", "contact", "status_dur")


@pytest.mark.parametrize("name", sorted(gait.GAITS))
def test_mode_schedule_matches_jax(name):
    got = gait.build_mode_schedule(gait.GAITS[name], 1.3, 0.05, 0.1)
    want = jgait.build_mode_schedule(jgait.GAITS[name], 1.3, 0.05, 0.1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for leg in range(4):
        assert gait.leg_intervals(*got, leg) == jgait.leg_intervals(*want,
                                                                   leg)


def _write_csv(path, ref):
    """A quad_reference.csv of `ref`'s records (body state on file is
    [eul, pos, eulrate, vel])."""
    rng = np.random.default_rng(3)
    lines = ["dt", f"{ref.dt!r}"]
    for k in range(len(ref)):
        bs = ref.body_state[k]
        rows = dict(
            body_state=np.concatenate([bs[3:6], bs[0:3], bs[9:12], bs[6:9]]),
            jnt_angle=ref.qJ[k], jnt_vel=rng.normal(size=12),
            torque=rng.normal(size=12),
            foot_placements=ref.foot_placements[k],
            foot_velocities=ref.foot_velocities[k],
            foot_height=ref.foot_heights[k], grf=ref.grf[k],
            contact=ref.contact[k], status_dur=ref.status_dur[k])
        for key, v in rows.items():
            lines += [key, " ".join(repr(float(x)) for x in v)]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("reorder", [False, True])
def test_load_quad_reference_matches_jax(tmp_path, reorder):
    f = tmp_path / "quad_reference.csv"
    _write_csv(f, synthetic_bound_reference(duration=0.3))
    got = qr.load_quad_reference(str(f), reorder=reorder)
    want = jqr.load_quad_reference(str(f), reorder=reorder)
    assert got.dt == want.dt
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


def test_reference_queries_match_jax():
    ref = synthetic_bound_reference(duration=1.0)
    a, b = qr.QuadReference(ref), jqr.QuadReference(ref)
    a.initialize(0.3)
    b.initialize(0.3)
    for step in range(3):
        for t in np.arange(0.0, 0.32, 0.005):
            np.testing.assert_array_equal(qr.hkd_state_ref_at(a, t),
                                          jqr.hkd_state_ref_at(b, t))
            np.testing.assert_array_equal(qr.hkd_control_ref_at(a, t),
                                          jqr.hkd_control_ref_at(b, t))
            np.testing.assert_array_equal(a.contact_duration_at_t(t),
                                          b.contact_duration_at_t(t))
        a.step(0.02)
        b.step(0.02)


def test_warm_start_matches_jax():
    """Two consecutive MPC plans: the solution of the first, carried onto
    the second, lands on the same rows in both packages."""
    q = qr.QuadReference(synthetic_bound_reference(duration=1.0))
    q.initialize(0.3)
    cfg = hp.HKDConfig(plan_duration=0.3, n_steps_max=40)
    old, _, _, _, _ = hp.build_hkd_plan(q, cfg)
    q.step(0.02)
    new, _, Xbar0, Ubar0, _ = hp.build_hkd_plan(q, cfg)
    rng = np.random.default_rng(0)
    oX = rng.normal(size=Xbar0.shape)
    oU = rng.normal(size=Ubar0.shape)
    got = ws.time_aligned_warm_start(old.knot, 0.0, oX, oU, new.knot, 0.02,
                                     Xbar0, Ubar0)
    want = jws.time_aligned_warm_start(old.knot, 0.0, oX, oU, new.knot,
                                       0.02, Xbar0, Ubar0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], Xbar0)


def test_hkd_config_defaults_match_jax():
    assert hp.HKDConfig() == hp.HKDConfig(**vars(jhp.HKDConfig()))

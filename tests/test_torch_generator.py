"""The port's offline reference generator (`reference/{gait, generator,
acrobatic}.py`) against the JAX package, f64 on CPU, on the synthetic
quadruped URDF loaded into both packages: gait schedules equal, joint
angles and body states to 1e-10 (the Newton IK is warm-started knot to
knot in the same order), every other record equal, and the
quad_reference.csv bytes equal to the JAX writer's."""
import copy

import numpy as np
import pytest
import torch

from cafempc_tpu.models import wbm as jwbm
from cafempc_tpu.reference import acrobatic as jacro
from cafempc_tpu.reference import gait as jgait
from cafempc_tpu.reference import generator as jgen
from cafempc_tpu_torch.models import rbda, synthetic_robot, wbm
from cafempc_tpu_torch.reference import acrobatic, gait, generator
from cafempc_tpu_torch.reference.quad_reference import load_quad_reference

TOL = 1e-10
EQUAL_FIELDS = ("contact", "foot_placements", "status_dur",
                "foot_velocities", "foot_heights", "grf", "qJd", "torque")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot")))
    return jwbm.load_model(path), wbm.load_model(path, "cpu", torch.float64)


# name -> (JAX call, port call), each taking the package's model
CASES = {
    "trot": (lambda m: jgen.generate_reference("trot", duration=1.0, vx=0.3,
                                               model=m),
             lambda m: generator.generate_reference("trot", duration=1.0,
                                                    vx=0.3, model=m)),
    "pace": (lambda m: jgen.generate_reference("pace", duration=1.0, vx=0.2,
                                               model=m),
             lambda m: generator.generate_reference("pace", duration=1.0,
                                                    vx=0.2, model=m)),
    "barrel_roll": (lambda m: jacro.generate_barrel_roll_reference(model=m),
                    lambda m: acrobatic.generate_barrel_roll_reference(
                        model=m)),
    "run_jump": (lambda m: jacro.generate_run_jump_reference(2, 2, model=m),
                 lambda m: acrobatic.generate_run_jump_reference(2, 2,
                                                                 model=m)),
}


@pytest.fixture(scope="module")
def generated(models):
    """name -> (JAX reference, port reference), made on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            jax_call, port_call = CASES[name]
            cache[name] = (jax_call(models[0]), port_call(models[1]))
        return cache[name]
    return get


@pytest.mark.parametrize("initial_stance", [0.0, 0.05])
def test_build_schedule_from_gaits_matches_jax(initial_stance):
    """The run-jump's composition: stance, bounds, a stretched-flight jump,
    an end stance, more bounds."""
    def gaits(mod):
        jump = copy.copy(mod.GAITS["bound"])
        jump.switching_times = np.array([0.0, 0.10, 0.20, 0.40, 0.75])
        return ([mod.GAITS["stance"]] + [mod.GAITS["bound"]] * 2
                + [jump, mod.GAITS["stance"]] + [mod.GAITS["flypace"]])
    got = gait.build_schedule_from_gaits(gaits(gait), initial_stance)
    want = jgait.build_schedule_from_gaits(gaits(jgait), initial_stance)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[0] + 1 == got[1].shape[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax(generated, name):
    want, got = generated(name)
    assert len(got) == len(want) and got.dt == want.dt
    np.testing.assert_allclose(got.qJ, want.qJ, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.body_state, want.body_state, rtol=0,
                               atol=TOL)
    for f in EQUAL_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_csv_bytes_match_jax_writer(generated, name, tmp_path):
    want, got = generated(name)
    jgen.write_quad_reference_csv(want, tmp_path / "jax.csv")
    generator.write_quad_reference_csv(got, tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() \
        == (tmp_path / "jax.csv").read_bytes()
    back = load_quad_reference(tmp_path / "port.csv")
    np.testing.assert_array_equal(back.contact, got.contact)
    assert np.abs(back.body_state - got.body_state).max() < 1e-4


@pytest.mark.parametrize("name", sorted(CASES))
def test_stance_feet_reach_their_targets(generated, models, name):
    """The port's IK puts every stance foot on its target (the JAX
    package's test_generated_reference_ik_consistency, at every stance
    knot)."""
    _, ref = generated(name)
    q = torch.as_tensor(np.concatenate([ref.body_state[:, :6], ref.qJ], 1))
    pf = rbda.foot_kinematics(models[1], q).reshape(len(ref), 12).numpy()
    stance = np.repeat(ref.contact > 0, 3, axis=1)
    assert stance.any()
    assert np.abs(pf - ref.foot_placements)[stance].max() < 1e-8


def test_barrel_roll_reference_shape(generated):
    """The roll ramps 0 -> 2 pi over the flight, in which no foot is in
    contact; the run-jump has exactly one flight longer than 0.3 s."""
    _, br = generated("barrel_roll")
    fly = br.contact.sum(1) == 0
    assert fly.sum() == 45 and br.body_state[0, 5] == 0.0
    assert br.body_state[-1, 5] == pytest.approx(2 * np.pi)
    _, rj = generated("run_jump")
    times = np.flatnonzero(np.diff(np.r_[0, (rj.contact.sum(1) == 0), 0]))
    runs = (times[1::2] - times[0::2]) * rj.dt
    assert (runs > 0.3).sum() == 1


def test_generator_needs_the_model():
    with pytest.raises(TypeError):
        generator.generate_reference("trot", duration=0.2)
    with pytest.raises(TypeError):
        acrobatic.generate_barrel_roll_reference()

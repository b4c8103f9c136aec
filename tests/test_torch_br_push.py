"""The benchmark's pushed barrel roll (`benchmark/configs/br.json`, the
`barrel_roll` problem of `benchmark/problems/`): the port's batched solve
against the benchmark's plain reference (`benchmark/reference/plain`, a
frozen copy of the port's plain path that imports nothing of the port).

CPU, f64: B=2 start states `initial_state()` with the body's linear
velocity (states 18:21) pushed by N(0, 0.2^2) per axis from a fixed
seed, 1 AL x 1 DDP (the configuration's 2 x 2 cut for time; the plan,
constraints, settings and solver keywords are the configuration's).  The
port runs every kernel as its plain twin (`plain_ops=True`), so both
sides do the same f64 arithmetic.
"""
import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.problems import barrel_roll as bp
from cafempc_tpu_torch.parallel.mesh import make_batched_solver
from torch_port_inputs import one_torch_thread  # noqa: F401 (fixture)

B = 2
SEED = 19
PUSH_SIGMA = 0.2
# the same f64 operations in the same order on both sides (they agree bit
# for bit); the room is for the last bits of reductions that another
# thread count may split differently
COST_RTOL = 1e-12
# Xbar entries reach ~10 (a roll angle of 2 pi, joint rates): ~1e-11 of it
TRAJ_ATOL = 1e-10
# feedback gains reach ~35: 1e-8 is ~3e-10 of the largest, as the K of a
# Riccati sweep amplifies the rounding of its inputs most
GAIN_ATOL = 1e-8


@pytest.fixture(scope="module")
def solved(one_torch_thread):
    cfg = harness.load_json(harness.HERE / "configs" / "br.json")
    cfg["batched"]["opts"].update(max_AL_iter=1, max_DDP_iter=1)
    f64, cpu = torch.float64, torch.device("cpu")
    gait, models = bp.make_gait(cfg), bp.make_models()
    try:
        p = bp.program_batched(cfg, gait, cpu, f64, B, models)
        x0 = np.tile(bp.nominal_x0(cfg, gait), (B, 1))
        x0[:, 18:21] += np.random.default_rng(SEED).normal(
            0.0, PUSH_SIGMA, (B, 3))
        x0 = torch.as_tensor(x0)
        solve = make_batched_solver(p["fns"], p["opts"], plain_ops=True,
                                    **p["solver_kw"])
        res = solve(p["plan"], p["pen"], x0, p["Xbar0"], p["Ubar0"])
        ref = bp.reference_batched(cfg, gait, cpu, f64, x0, models)
    finally:
        models.close()
    return x0, res, ref


def test_pushes_touch_the_body_velocity_only(solved):
    x0 = solved[0].numpy()
    nominal = np.tile(bp.ref_br().initial_state(), (B, 1))
    moved = np.abs(x0 - nominal) > 0
    assert moved[:, 18:21].all() and not moved[:, :18].any() \
        and not moved[:, 21:].any()
    assert not np.array_equal(x0[0], x0[1])


def test_port_matches_the_plain_reference(solved):
    _, res, (cost, ok, X, K) = solved
    assert ok.all() and res.success.all()
    assert np.isfinite(cost).all()
    np.testing.assert_allclose(res.cost.numpy(), cost, rtol=COST_RTOL)
    np.testing.assert_allclose(res.Xbar.numpy(), X, rtol=0, atol=TRAJ_ATOL)
    np.testing.assert_allclose(res.K.numpy(), K, rtol=0, atol=GAIN_ATOL)
    # the roll happened: the body turns by about 2 pi over the plan
    assert (res.Xbar[:, :, 5].amax(1) > 5.0).all()

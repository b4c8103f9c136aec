"""The port's scale-out layer (`cafempc_tpu_torch/parallel/{knot_riccati,
mesh}.py` and the solver's `knot_axis` sweep) against the JAX package's,
f64 on CPU, on the same seeded numpy inputs.

* The knot-sharded value sweep (`sharded_riccati_GH`) on a mesh of 8 CPU
  devices against JAX's on the 8 virtual devices of tests/conftest.py, at
  tests/test_knot_riccati.py's horizons (N = 23, which pads, and 32, with
  resets inside blocks and on a block boundary) and at its cascade500
  horizon (N=526, xs=36, us=12, 26 resets; one scenario): G and H to
  1e-10, normalized by the largest |value|; and against the port's exact
  sequential sweep to the JAX test's own 1e-7.
* The meshed solve: `make_batched_solver(mesh=scenario_knot_mesh(2, 4))`
  at tests/test_knot_riccati.py:150-217's configuration (HKD, plan 0.3 s,
  40 steps, B=2, 2 AL x 1 DDP, sequential line search, 16 gathered
  resets, reg floor 1e-3) on the synthetic bound reference (Cheetah
  order), against the JAX meshed solve and against the port's
  `parallel_riccati` solve without a mesh: cost rtol 1e-9, Xbar and Ubar
  1e-8, K 1e-7; and a scenario mesh of 2 CPU devices, equal to the
  unsharded solve.
* The mesh constructors, `shard_batch` / `replicate`, and the solver's
  refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafempc_tpu.parallel import knot_riccati as jkr
from cafempc_tpu.parallel import mesh as jmesh
from cafempc_tpu.problems import hkd_problem as jhp
from cafempc_tpu.solver.options import SolverOptions as JaxSolverOptions
from cafempc_tpu.solver.plan import host_plan_to_device as jax_to_device
from cafempc_tpu_torch.convert import from_numpy, to_numpy
from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.parallel import knot_riccati as kr
from cafempc_tpu_torch.parallel.mesh import (Mesh, Shards, broadcast_batch,
                                             make_batched_solver, replicate,
                                             scenario_knot_mesh,
                                             scenario_mesh, shard_batch)
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.reference.synthetic import synthetic_bound_reference
from cafempc_tpu_torch.solver import hsddp
from cafempc_tpu_torch.solver.options import SolverOptions
from torch_port_inputs import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
GH_TOL = 1e-10        # port against JAX, normalized
EXACT_TOL = 1e-7      # against the exact sequential sweep (the JAX test's)
NAMES = ("A", "B", "C", "D", "lx", "lu", "ly", "lxx", "luu", "lux", "lyy",
         "phix", "phixx", "defect")


def _operands(seed, Bsz, N, xs, us, ys, resets, near_identity):
    """Seeded [Bsz, ...] operands laid out as tests/test_knot_riccati.py's
    (its two generators: random A at the short horizons, near-identity A
    at the cascade500 one), and the reset mask w [N]."""
    rng = np.random.default_rng(seed)
    s, spd_s, shift = (0.2, 0.15, 0.8) if near_identity else (0.4, 0.3, 0.5)

    def mk(shape, sc=s):
        return rng.normal(size=(Bsz,) + shape) * sc

    def spd(n, count, sc=spd_s):
        M = rng.normal(size=(Bsz, count, n, n)) * sc
        return np.einsum("bkij,bkmj->bkim", M, M) + shift * np.eye(n)

    if near_identity:
        A = np.eye(xs) + mk((N, xs, xs), 0.03)
        Bm, C, D = mk((N, xs, us), 0.1), mk((N, ys, xs), 0.05), \
            mk((N, ys, us), 0.05)
        lux, lyy, dsc = mk((N, us, xs), 0.02), spd(ys, N, 0.05), 0.005
    else:
        A = mk((N, xs, xs))
        Bm, C, D = mk((N, xs, us)), mk((N, ys, xs), 0.2), mk((N, ys, us),
                                                             0.2)
        lux, lyy, dsc = mk((N, us, xs), 0.05), spd(ys, N, 0.1), 0.01
    ops = dict(A=A, B=Bm, C=C, D=D, lx=mk((N, xs)), lu=mk((N, us)),
               ly=mk((N, ys)), lxx=spd(xs, N), luu=spd(us, N), lux=lux,
               lyy=lyy, phix=mk((N + 1, xs)), phixx=spd(xs, N + 1),
               defect=mk((N + 1, xs), dsc))
    w = np.zeros(N, bool)
    w[list(resets)] = True
    return ops, w


# (operands, reg): two scenarios at the short horizons, one at cascade500's
CASES = {
    "N23": (dict(Bsz=2, N=23, xs=6, us=3, ys=2, resets=(5, 8, 16),
                 near_identity=False), 0.05),
    "N32": (dict(Bsz=2, N=32, xs=6, us=3, ys=2, resets=(5, 8, 16),
                 near_identity=False), 0.05),
    "cascade500": (dict(Bsz=1, N=526, xs=36, us=12, ys=12,
                        resets=np.linspace(10, 516, 26).astype(int),
                        near_identity=True), 0.05),
}


def _normalized_err(got, want):
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _exact_GH(ops, w, reg):
    """The port's exact sequential sweep (G, H) on the same operands."""
    z = {k: torch.zeros(1) for k in hsddp.TrajState._fields}
    z.update({k: torch.as_tensor(ops[k]) for k in NAMES if k != "defect"})
    Bsz, N, xs = ops["lx"].shape
    us = ops["lu"].shape[-1]
    z.update(Defect=torch.as_tensor(ops["defect"]),
             Xbar=torch.zeros(Bsz, N + 1, xs, dtype=torch.float64),
             Ubar=torch.zeros(Bsz, N, us, dtype=torch.float64))
    plan = type("P", (), {})()
    plan.step = type("S", (), dict(
        is_reset=torch.as_tensor(w.astype(float)),
        active=torch.ones(N, dtype=torch.float64)))()
    outs, _, _, ok = hsddp.make_solver(hp.make_hkd_fns(), SolverOptions()) \
        ._backward_sweep(plan, hsddp.TrajState(**z),
                         torch.full((Bsz,), reg, dtype=torch.float64))
    assert bool(ok.all())
    return outs[0].numpy(), outs[1].numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_riccati_matches_jax_and_exact_sweep(case):
    spec, reg = CASES[case]
    ops, w = _operands(7, **spec)
    mesh = kr.knot_mesh(8, devices=[CPU] * 8)
    G, H = kr.sharded_riccati_GH(
        *[torch.as_tensor(ops[k]) for k in NAMES], torch.as_tensor(w), reg,
        mesh)
    G, H = G.numpy(), H.numpy()
    jmesh8 = jkr.knot_mesh(8)
    jfn = jax.jit(lambda *a: jkr.sharded_riccati_GH(*a, reg=reg,
                                                    mesh=jmesh8))
    for b in range(spec["Bsz"]):
        Gj, Hj = jfn(*[jnp.asarray(ops[k][b]) for k in NAMES],
                     jnp.asarray(w))
        assert _normalized_err(G[b], np.asarray(Gj)) <= GH_TOL
        assert _normalized_err(H[b], np.asarray(Hj)) <= GH_TOL
    Ge, He = _exact_GH(ops, w, reg)
    assert _normalized_err(G, Ge) <= EXACT_TOL
    assert _normalized_err(H, He) <= EXACT_TOL


def test_blocks_on_several_devices_match_one_scan():
    """The same elements over 4 blocks on 4 mesh entries and over one
    block: the tail transforms join the blocks into the whole suffix
    composition."""
    ops, w = _operands(3, Bsz=2, N=23, xs=6, us=3, ys=2, resets=(5, 8, 16),
                       near_identity=False)
    args = [torch.as_tensor(ops[k]) for k in NAMES] + [torch.as_tensor(w),
                                                       0.05]
    G4, H4 = kr.sharded_riccati_GH(*args, kr.knot_mesh(
        devices=[CPU] * 4))
    G1, H1 = kr.sharded_riccati_GH(*args, kr.knot_mesh(devices=[CPU]))
    assert _normalized_err(G4.numpy(), G1.numpy()) <= GH_TOL
    assert _normalized_err(H4.numpy(), H1.numpy()) <= GH_TOL


# ------------------------------------------------------- meshed solves
B = 2
OPTS = dict(max_AL_iter=2, max_DDP_iter=1)
KW = dict(trim_output=True, parallel_line_search=False, max_resets=16,
          reg_floor=1e-3)


@pytest.fixture(scope="module")
def hkd_case():
    """test_knot_riccati.py:168-192's problem on the synthetic bound
    reference (Cheetah order): plan 0.3 s, 40 steps; x0 the bench pose +
    N(0, 0.01), seed 0."""
    qr = QuadReference(synthetic_bound_reference(duration=2.0))
    qr.initialize(0.3)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(
        qr, hp.HKDConfig(plan_duration=0.3, n_steps_max=40))
    body = np.zeros(12)
    body[5] = 0.2486
    f64 = torch.float64
    qd = hkd.compute_hkd_state(
        torch.tensor(body[0:3], dtype=f64), torch.tensor(body[3:6],
                                                         dtype=f64),
        torch.tensor([0.0, -0.8, 1.6] * 4, dtype=f64),
        torch.tensor(meta["phases"][0][3], dtype=f64))
    x0 = np.concatenate([body, qd.numpy()])
    x0_b = x0[None] + np.random.default_rng(0).normal(0, 0.01, (B, 24))
    return plan_np, pen_np, x0_b, Xbar0, Ubar0


def _port_args(case):
    plan_np, pen_np, x0_b, Xbar0, Ubar0 = case
    plan, pen, x0_b, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, x0_b, Xbar0, Ubar0), CPU, torch.float64)
    return (plan, broadcast_batch(pen, B), x0_b, broadcast_batch(Xbar0, B),
            broadcast_batch(Ubar0, B))


@pytest.fixture(scope="module")
def port_parallel(hkd_case):
    return to_numpy(make_batched_solver(
        hp.make_hkd_fns(), SolverOptions(**OPTS), parallel_riccati=True,
        **KW)(*_port_args(hkd_case)))


@pytest.fixture(scope="module")
def port_meshed(hkd_case):
    mesh = scenario_knot_mesh(2, 4, devices=[CPU] * 8)
    return to_numpy(make_batched_solver(
        hp.make_hkd_fns(), SolverOptions(**OPTS), mesh=mesh, **KW)(
        *_port_args(hkd_case)))


def _assert_close(got, want):
    np.testing.assert_array_equal(got.success, want.success)
    assert got.success.all()
    for f in ("iters", "ls_iters", "reg_iters"):
        np.testing.assert_array_equal(getattr(got.info, f),
                                      getattr(want.info, f), err_msg=f)
    np.testing.assert_allclose(got.cost, want.cost, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.Xbar, want.Xbar, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.Ubar, want.Ubar, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.K, want.K, rtol=0, atol=1e-7)


def test_meshed_solve_matches_jax_meshed_solve(hkd_case, port_meshed):
    plan_np, pen_np, x0_b, Xbar0, Ubar0 = hkd_case

    def batch(a):
        a = jnp.asarray(np.asarray(a), jnp.float64)
        return jnp.broadcast_to(a, (B,) + a.shape)

    mesh2 = jmesh.scenario_knot_mesh(2, 4)
    solve = jmesh.make_batched_solver(jhp.make_hkd_fns(),
                                      JaxSolverOptions(**OPTS), mesh=mesh2,
                                      **KW)
    plan = jmesh.replicate(jax_to_device(plan_np, dtype=jnp.float64), mesh2)
    args = jmesh.shard_batch((jax.tree.map(batch, pen_np),
                              jnp.asarray(x0_b), batch(Xbar0),
                              batch(Ubar0)), mesh2)
    want = jax.tree.map(np.asarray, solve(plan, *args))
    _assert_close(port_meshed, want)


def test_meshed_solve_matches_parallel_riccati_solve(port_meshed,
                                                     port_parallel):
    _assert_close(port_meshed, port_parallel)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("placed", [False, True])
def test_scenario_mesh_solve_equals_unsharded_solve(hkd_case, placed):
    """A scenario mesh of 2 CPU devices (one scenario a shard), with the
    inputs as tensors or placed by shard_batch / replicate: bit for bit
    the unsharded solves of its shards, concatenated; and the unsharded
    B=2 solve, equal in flags and iterations and within 1e-12 (CPU BLAS
    rounds a batch of 2 otherwise than two batches of 1)."""
    kw = dict(KW, fused_riccati=True)
    solve = make_batched_solver(hp.make_hkd_fns(), SolverOptions(**OPTS),
                                **kw)
    args = _port_args(hkd_case)
    whole = to_numpy(solve(*args))
    shards = [to_numpy(solve(args[0], *[
        type(a)(*[t[b:b + 1] for t in a]) if isinstance(a, tuple)
        else a[b:b + 1] for a in args[1:]])) for b in range(B)]
    mesh = scenario_mesh(devices=[CPU] * 2)
    if placed:
        args = (replicate(args[0], mesh),) + shard_batch(args[1:], mesh)
        assert isinstance(args[2], Shards) and len(args[2]) == 2
    got = to_numpy(make_batched_solver(hp.make_hkd_fns(),
                                       SolverOptions(**OPTS), mesh=mesh,
                                       **kw)(*args))
    for g, x, *parts in zip(_leaves(got), _leaves(whole),
                            *map(_leaves, shards)):
        np.testing.assert_array_equal(g, np.concatenate(parts))
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, x, rtol=1e-12,
                                       atol=1e-12 * np.abs(x).max())
        else:
            np.testing.assert_array_equal(g, x)


# -------------------------------------------------- meshes and refusals
def test_meshes_name_their_axes():
    m = scenario_knot_mesh(2, 4, devices=[CPU] * 8)
    assert isinstance(m, Mesh) and m.shape == {"scenario": 2, "knot": 4}
    assert m.devices.shape == (2, 4)
    assert scenario_mesh(1, devices=[CPU] * 3).shape == {"scenario": 1}
    assert kr.knot_mesh(devices=["cpu"] * 3).shape == {"knot": 3}
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        scenario_knot_mesh(2, 4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        scenario_mesh(3, devices=[CPU] * 2)


def test_shard_batch_splits_and_replicate_copies():
    mesh = scenario_knot_mesh(2, 2, devices=[CPU] * 4)
    x = torch.arange(12.0).reshape(4, 3)
    sx, = shard_batch((x,), mesh)
    assert [p.tolist() for p in sx] == [x[:2].tolist(), x[2:].tolist()]
    rx = replicate({"a": x}["a"], mesh)
    assert len(rx) == 2 and all(torch.equal(p, x) for p in rx)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(torch.zeros(3, 2), mesh)


def test_knot_axis_refusals():
    fns = hp.make_hkd_fns()
    with pytest.raises(ValueError, match="knot_shards >= 2"):
        hsddp.make_solver(fns, SolverOptions(), knot_axis="knot",
                          knot_shards=1)
    with pytest.raises(ValueError, match="knot_devices"):
        hsddp.make_solver(fns, SolverOptions(), knot_axis="knot",
                          knot_shards=2, knot_devices=[CPU])
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_batched_solver(fns, SolverOptions(), fused_riccati=True,
                            mesh=scenario_knot_mesh(1, 2,
                                                    devices=[CPU] * 2))

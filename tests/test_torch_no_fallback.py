"""No silent fallback: the kernels' wrappers take the plain twins only for
CPU tensors; anything else launches a kernel or raises, and a machine
without CUDA refuses the solver's CUDA path and the chip smoke run."""
import os
import subprocess
import sys

import pytest
import torch

from cafempc_tpu_torch.convert import from_numpy
from cafempc_tpu_torch.models import synthetic_robot, wbm
from cafempc_tpu_torch.ops import _ext, hkd_table
from cafempc_tpu_torch.ops import hkd_lq as hl
from cafempc_tpu_torch.ops import hkd_trial as ht
from cafempc_tpu_torch.ops import linroll as lr
from cafempc_tpu_torch.ops import sweep as sw
from cafempc_tpu_torch.parallel.mesh import (broadcast_batch,
                                             make_batched_solver)
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference, synthetic_bound_reference_urdf)
from cafempc_tpu_torch.solver.hsddp import SegmentedFns
from cafempc_tpu_torch.solver.options import SolverOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sweep_args(device):
    Bsz, N, xs, us = 2, 3, 4, 2
    f = dict(dtype=torch.float32, device=device)
    return (torch.zeros(Bsz, N, xs, xs, **f), torch.zeros(Bsz, N, xs, us, **f),
            torch.zeros(Bsz, N, xs, **f), torch.zeros(Bsz, N, us, **f),
            torch.zeros(Bsz, N, xs, xs, **f), torch.zeros(Bsz, N, us, us, **f),
            torch.zeros(Bsz, N, us, xs, **f), torch.zeros(Bsz, xs, **f),
            torch.zeros(Bsz, xs, xs, **f), torch.zeros(Bsz, N + 1, xs, **f),
            torch.zeros(N, dtype=torch.int32, device=device),
            torch.zeros(Bsz, **f))


def _hkd_lq_args(device, Bsz=2, N=3):
    f = dict(dtype=torch.float32, device=device)
    return (torch.zeros(Bsz, N + 1, 24, **f), torch.zeros(Bsz, N, 24, **f),
            *[torch.ones(Bsz, N, 20, **f) for _ in range(3)],
            *[torch.zeros(Bsz, N + 1, 4, **f) for _ in range(3)],
            torch.zeros(N + 1, hkd_table.NCOLS, **f), 0.7)


def _hkd_trial_args(device, Bsz=2, N=3):
    f = dict(dtype=torch.float32, device=device)
    X, U, *pen, table, mu = _hkd_lq_args(device, Bsz, N)
    return (torch.ones(Bsz, **f), torch.zeros(Bsz, 24, **f), X,
            torch.zeros_like(X), U, torch.zeros_like(U), *pen, table, mu)


HKD_OPS = {"hkd_lq": (hl.hkd_lq, _hkd_lq_args),
           "hkd_trial": (ht.hkd_trial, _hkd_trial_args)}


@pytest.mark.parametrize("op", sorted(HKD_OPS))
def test_hkd_wrappers_raise_for_non_cpu_devices_without_kernel(op):
    """The fused HKD wrappers never reach their plain twins for a tensor
    on a device that is neither CPU nor CUDA."""
    fn, make_args = HKD_OPS[op]
    with pytest.raises(ValueError, match="no kernel"):
        fn(*make_args("meta"))


@pytest.mark.parametrize("op", sorted(HKD_OPS))
def test_hkd_wrappers_run_the_twin_on_cpu_and_count_no_launch(op):
    fn, make_args = HKD_OPS[op]
    before = fn.launches
    out = fn(*make_args("cpu"))
    assert out[0].shape == ((2, 3, 24, 24) if op == "hkd_lq" else (2, 4, 24))
    assert fn.launches == before
    bad = list(make_args("cpu"))
    bad[-2] = bad[-2][:, :-1]
    with pytest.raises(ValueError, match="table has shape"):
        fn(*bad)


# (N, dtype, what the wrapper raises for meta tensors): the longest plans
# whose scenario fits one CTA's shared memory reach the device check, one
# step more is refused for its length
TRIAL_LENGTHS = [(401, torch.float64, "for device meta"),
                 (402, torch.float64, "for N=402"),
                 (804, torch.float32, "for device meta"),
                 (805, torch.float32, "for N=805")]


@pytest.mark.parametrize("N,dtype,match", TRIAL_LENGTHS)
def test_hkd_trial_refuses_plans_too_long_for_its_kernel(N, dtype, match):
    args = [a.to(dtype) if torch.is_tensor(a) else a
            for a in _hkd_trial_args("meta", 1, N)]
    before = ht.hkd_trial.launches
    with pytest.raises(ValueError, match=match):
        ht.hkd_trial(*args)
    assert ht.hkd_trial.launches == before


def test_cuda_solve_refused_without_cuda():
    """Asking for the solver's CUDA path on a machine without CUDA raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    qr = QuadReference(synthetic_bound_reference(duration=1.0))
    qr.initialize(0.3)
    plan_np, pen_np, _, _, _ = hp.build_hkd_plan(
        qr, hp.HKDConfig(plan_duration=0.3, n_steps_max=40))
    with pytest.raises((RuntimeError, AssertionError)):
        from_numpy((plan_np, pen_np), "cuda", torch.float32)


@pytest.mark.parametrize("op", ["sweep", "linroll"])
def test_wrappers_raise_for_non_cpu_devices_without_kernel(op):
    """A tensor on a device that is neither CPU nor CUDA never reaches the
    plain twin."""
    if op == "sweep":
        with pytest.raises(ValueError, match="no kernel"):
            sw.sweep(*_sweep_args("meta"))
    else:
        m = torch.zeros(2, 3, 4, 4, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            lr.linroll(m, torch.zeros(2, 3, 4, device="meta"),
                       torch.zeros(2, 4, device="meta"))


def test_cpu_tensors_run_the_twin_and_count_no_launch():
    before = (sw.sweep.launches, lr.linroll.launches)
    out = sw.sweep(*_sweep_args("cpu"))
    assert out[0].shape == (2, 3, 4)
    lr.linroll(torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 4),
               torch.zeros(2, 4))
    assert (sw.sweep.launches, lr.linroll.launches) == before


# (xs, us, dtype, devices that refuse): widths past the kernel's limits
# (us > 32, xs > 40) are refused on every device; rows that are not a
# multiple of 16 bytes only where a kernel would run (the CPU runs the twin)
REFUSED = [(4, 33, torch.float32, ("cpu", "meta")),
           (41, 2, torch.float32, ("cpu", "meta")),
           (6, 4, torch.float32, ("meta",)),
           (4, 3, torch.float64, ("meta",)),
           (6, 3, torch.float32, ("meta",))]


@pytest.mark.parametrize("xs,us,dtype,devices", REFUSED)
def test_sweep_refuses_widths_the_kernel_does_not_take(xs, us, dtype,
                                                       devices):
    """A width the kernel does not take raises and counts no launch: the
    wrapper never falls back to the twin for a shape its kernel would
    refuse."""
    Bsz, N = 2, 3
    f = dict(dtype=dtype)
    args = (torch.zeros(Bsz, N, xs, xs, **f), torch.zeros(Bsz, N, xs, us, **f),
            torch.zeros(Bsz, N, xs, **f), torch.zeros(Bsz, N, us, **f),
            torch.zeros(Bsz, N, xs, xs, **f), torch.zeros(Bsz, N, us, us, **f),
            torch.zeros(Bsz, N, us, xs, **f), torch.zeros(Bsz, xs, **f),
            torch.zeros(Bsz, xs, xs, **f), torch.zeros(Bsz, N + 1, xs, **f),
            torch.zeros(N, dtype=torch.int32), torch.zeros(Bsz, **f))
    before = sw.sweep.launches
    for device in devices:
        with pytest.raises(ValueError, match="no kernel for xs="):
            sw.sweep(*(a.to(device) for a in args))
    if "cpu" not in devices:    # the twin takes any row width
        assert sw.sweep(*args)[0].shape == (Bsz, N, xs)
    assert sw.sweep.launches == before


# (xs, dtype, devices that refuse): linroll's limits, those of the sweep
# it runs beside: xs > 40 on every device, and rows that are not a
# multiple of 16 bytes only where a kernel would run
LINROLL_REFUSED = [(41, torch.float32, ("cpu", "meta")),
                   (6, torch.float32, ("meta",)),
                   (3, torch.float64, ("meta",))]


@pytest.mark.parametrize("xs,dtype,devices", LINROLL_REFUSED)
def test_linroll_refuses_widths_the_kernel_does_not_take(xs, dtype, devices):
    """A width the kernel does not take raises and counts no launch; where
    only the kernel refuses it, the CPU twin still answers."""
    Bsz, N = 2, 3
    args = (torch.zeros(Bsz, N, xs, xs, dtype=dtype),
            torch.zeros(Bsz, N, xs, dtype=dtype), torch.zeros(Bsz, xs,
                                                              dtype=dtype))
    before = lr.linroll.launches
    for device in devices:
        with pytest.raises(ValueError, match="no kernel for xs="):
            lr.linroll(*(a.to(device) for a in args))
    if "cpu" not in devices:
        assert lr.linroll(*args).shape == (Bsz, N, xs)
    assert lr.linroll.launches == before


def test_wrapper_rejects_bad_shapes():
    args = list(_sweep_args("cpu"))
    args[10] = args[10].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        sw.sweep(*args)
    with pytest.raises(ValueError, match="shape"):
        lr.linroll(torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 5),
                   torch.zeros(2, 4))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _ext.nvcc_path()


def test_unported_variants_raise(monkeypatch):
    """The device meshes are ported and take no stand-in: a mesh that is
    not a parallel.mesh.Mesh is refused, and without a CUDA device a mesh
    is built only from explicit devices (no CPU fallback)."""
    from cafempc_tpu_torch.parallel.mesh import (scenario_knot_mesh,
                                                 scenario_mesh)
    fns = hp.make_hkd_fns()
    with pytest.raises(TypeError, match="mesh"):
        make_batched_solver(fns, SolverOptions(), mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (scenario_mesh, lambda: scenario_knot_mesh(1, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert scenario_mesh(devices=["cpu"]).shape == {"scenario": 1}


@pytest.fixture(scope="module")
def mhpc_model(tmp_path_factory):
    return wbm.load_model(synthetic_robot.write_synthetic_quadruped_urdf(
        str(tmp_path_factory.mktemp("robot"))), "cpu", torch.float64)


MHPC_PLAN = dict(plan_dur_wb=0.1, plan_dur_srb=0.2, n_steps_max=24,
                 wb_block=16)


def test_unknown_mhpc_mode_raises(mhpc_model):
    """make_mhpc_fns takes the JAX package's modes (joint, wb, srb) and
    refuses any other, where the JAX function would build the joint mode."""
    with pytest.raises(ValueError, match="unknown mode"):
        mp.make_mhpc_fns(mp.MHPCConfig(**MHPC_PLAN), mhpc_model, "lane")


def _mhpc_problem(Bsz=1):
    qr = QuadReference(synthetic_bound_reference_urdf(duration=1.0))
    qr.initialize(0.4)
    cfg = mp.MHPCConfig(**MHPC_PLAN)
    plan_np, pen_np, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, cfg)
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, wb_state_ref_at(qr, 0.0), Xbar0, Ubar0), "cpu",
        torch.float64)
    return cfg, (plan, broadcast_batch(pen, Bsz), broadcast_batch(x0, Bsz),
                 broadcast_batch(Xbar0, Bsz), broadcast_batch(Ubar0, Bsz))


@pytest.mark.parametrize("counts", [(16, 7), (16, 9), (24,), (0, 24)])
def test_segmented_fns_with_counts_off_the_plan_raise(mhpc_model, counts):
    """SegmentedFns whose counts do not split the plan's 24 steps into
    positive segments, one per ProblemFns, are refused."""
    cfg, args = _mhpc_problem()
    seg = mp.make_mhpc_fns_segmented(cfg, mhpc_model)
    bad = SegmentedFns(counts=counts, fns=seg.fns)
    solve = make_batched_solver(bad, SolverOptions(max_AL_iter=1,
                                                   max_DDP_iter=1))
    with pytest.raises(ValueError, match="SegmentedFns: counts"):
        solve(*args)


def test_mhpc_solve_on_cpu_runs_the_twins_and_counts_no_launch(mhpc_model):
    """The segmented MHPC solve on CPU tensors goes through the plain
    twins of the sweep and the linear rollout: it succeeds and launches
    nothing."""
    cfg, args = _mhpc_problem()
    before = (sw.sweep.launches, lr.linroll.launches)
    res = make_batched_solver(
        mp.make_mhpc_fns_segmented(cfg, mhpc_model),
        SolverOptions(max_AL_iter=1, max_DDP_iter=1), fused_riccati=True,
        parallel_line_search=False, max_resets=16, reg_floor=1e-3)(*args)
    assert bool(res.success.all()) and bool(torch.isfinite(res.cost).all())
    assert int(res.info.iters[0]) == 1
    assert (sw.sweep.launches, lr.linroll.launches) == before


def test_fused_hooks_refuse_segmented_fns(mhpc_model):
    cfg, _ = _mhpc_problem()
    with pytest.raises(ValueError, match="SegmentedFns"):
        make_batched_solver(mp.make_mhpc_fns_segmented(cfg, mhpc_model),
                            SolverOptions(), fused_lq=lambda *a, **k: None)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device the chip smoke run exits non-zero and prints
    no result; alone in a directory it fails too."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for cwd, script in ((ROOT, "chip_smoke.py"),
                        (str(tmp_path), "chip_smoke.py")):
        if cwd != ROOT:
            with open(os.path.join(ROOT, script)) as src, \
                    open(tmp_path / script, "w") as dst:
                dst.write(src.read())
        env = dict(os.environ, PYTHONPATH="")
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_native_transport_raises_without_gxx(monkeypatch, tmp_path):
    """Without g++ the native transport and the C++ listener raise; no
    Python transport takes their place."""
    from cafempc_tpu_torch.comms import native
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.NativeUDPMulticast()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build_listener()
    assert native._LIB is None


class _Queue:
    """An in-memory transport holding what is published to it."""

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


def test_serve_lets_a_failed_solve_out():
    """An exception of a served solve leaves serve(); no command is
    published for that state."""
    import numpy as np
    from cafempc_tpu_torch.comms import lcm_wire as w
    from cafempc_tpu_torch.comms.udpm import LCMEndpoint
    from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
    qr = QuadReference(synthetic_bound_reference(duration=1.0))
    qr.initialize(0.3)
    rt = HKDMPCRuntime(qr, hp.HKDConfig(plan_duration=0.3, n_steps_max=40),
                       SolverOptions(), device="cpu")

    def broken(*args):
        raise FloatingPointError("solve failed")
    rt.solve_init = broken
    ep = LCMEndpoint(_Queue())
    ep.publish("mpc_data", w.hkd_data_lcmt(
        reset_mpc=True, MS=True, mpctime=0.0, contact=np.ones(4, np.int32),
        p=[0.0, 0.0, 0.25], vWorld=np.zeros(3), rpy=np.zeros(3),
        omegaBody=np.zeros(3), qJ=[0.0, -0.8, 1.6] * 4,
        foot_placements=np.zeros(12)))
    with pytest.raises(FloatingPointError, match="solve failed"):
        rt.serve(ep, max_msgs=1)
    assert not any(c == "mpc_command" for c, _ in ep.t.queue)


_FETCHES = ("cpu", "numpy", "item", "tolist")


def test_solver_without_iter_callback_adds_no_host_fetch(monkeypatch):
    """A small HKD solve copies nothing to the host without an
    iter_callback (its only host reads are the loop tests' `bool`); with
    one that fetches Xbar, one copy per AL outer iteration."""
    from cafempc_tpu_torch.solver.hsddp import make_solver
    qr = QuadReference(synthetic_bound_reference(duration=1.0))
    qr.initialize(0.3)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(
        qr, hp.HKDConfig(plan_duration=0.3, n_steps_max=40))
    plan, pen, Xbar0, Ubar0 = from_numpy((plan_np, pen_np, Xbar0, Ubar0),
                                         "cpu", torch.float64)
    args = (plan, broadcast_batch(pen, 1), Xbar0[0][None],
            Xbar0[None], Ubar0[None])
    calls = []
    for name in _FETCHES:
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _r=real,
                            _n=name, **k: calls.append(_n) or _r(self, *a,
                                                                   **k))
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
    make_solver(hp.make_hkd_fns(), opts)(*args)
    assert calls == []
    seen = []
    make_solver(hp.make_hkd_fns(), opts, iter_callback=lambda X, U, it: (
        seen.append(it), X.cpu()))(*args)
    assert seen == list(range(len(seen))) and 1 <= len(seen) <= 2
    assert calls == ["cpu"] * len(seen)


@pytest.mark.parametrize("example", ["two_process_hkd_mpc",
                                     "two_process_mhpc"])
def test_examples_default_to_cuda_and_refuse_without_it(example,
                                                        monkeypatch):
    """`--role mpc` serves on cuda unless --device cpu is given; without a
    CUDA device it refuses to start."""
    import importlib
    ex = importlib.import_module(f"cafempc_tpu_torch.examples.{example}")
    started = []
    monkeypatch.setattr(ex, "run_mpc", lambda *a: started.append(a))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            ex.main(["--role", "mpc"])
        assert started == []
    ex.main(["--role", "mpc", "--device", "cpu", "--steps", "3"])
    assert started == [("cpu", "udpm", 3)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ex.main(["--role", "mpc"])
    assert started[-1][0] == "cuda"


class _Stop(Exception):
    """Raised by a stand-in to end an example once it chose its device."""


@pytest.mark.parametrize("example", ["barrel_roll_demo", "loco_to_demo",
                                     "br_reference_demo"])
def test_offline_examples_default_to_cuda_and_refuse_without_it(
        example, monkeypatch, tmp_path):
    """The trajectory-optimization examples load their robot on cuda unless
    --device cpu is given; without a CUDA device they refuse to start."""
    import importlib
    ex = importlib.import_module(f"cafempc_tpu_torch.examples.{example}")
    seen = []

    def load_robot(urdf, out, device, dtype=torch.float64):
        seen.append(device)
        raise _Stop
    monkeypatch.setattr(ex, "load_robot", load_robot)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            ex.main(["--out", str(tmp_path)])
        assert seen == []
    with pytest.raises(_Stop):
        ex.main(["--out", str(tmp_path), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(_Stop):
        ex.main(["--out", str(tmp_path)])
    assert seen == ["cpu", "cuda"]


def test_hkd_mpc_demo_defaults_to_cuda_and_refuses_without_it(monkeypatch,
                                                              tmp_path):
    """The HKD-MPC demo makes its gait (and the runtime) on cuda unless
    --device cpu is given; without a CUDA device it refuses to start."""
    from cafempc_tpu_torch.examples import hkd_mpc_demo as ex
    seen = []

    def reference(gait, ref_csv, out, device, duration):
        seen.append(device)
        raise _Stop
    monkeypatch.setattr(ex, "reference", reference)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            ex.main(["--out", str(tmp_path)])
        assert seen == []
    with pytest.raises(_Stop):
        ex.main(["--out", str(tmp_path), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(_Stop):
        ex.main(["--out", str(tmp_path)])
    assert seen == ["cpu", "cuda"]


def test_scenario_sweep_defaults_to_cuda_and_refuses_without_it(
        monkeypatch, tmp_path):
    """The scenario sweep loads its robot on cuda unless --device cpu is
    given; without a CUDA device it refuses to start."""
    from cafempc_tpu_torch.tools import scenario_sweep as ss
    seen = []

    def load_model(urdf, device, dtype):
        seen.append(str(device))
        raise _Stop
    monkeypatch.setattr(ss.wbm, "load_model", load_model)
    argv = ["--out", str(tmp_path / "sweep.json")]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            ss.main(argv)
        assert seen == []
    with pytest.raises(_Stop):
        ss.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(_Stop):
        ss.main(argv)
    assert seen == ["cpu", "cuda"]


def test_hkd_runtime_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    """`HKDMPCRuntime` without a device runs on cuda; without a CUDA device
    it refuses to start instead of running on the CPU, which it does only
    when asked."""
    from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
    qr = QuadReference(synthetic_bound_reference(duration=1.0))
    qr.initialize(0.3)
    cfg = hp.HKDConfig(plan_duration=0.3, n_steps_max=40)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HKDMPCRuntime(qr, cfg, SolverOptions())
    assert HKDMPCRuntime(qr, cfg, SolverOptions(), device="cpu").device \
        == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert HKDMPCRuntime(qr, cfg, SolverOptions()).device == "cuda"


def test_scenario_sweep_refuses_a_missing_arcdog_urdf(monkeypatch, tmp_path):
    """`--arcdog-urdf` naming no file raises before any gait is made; the
    arcdog cases are never dropped silently."""
    from cafempc_tpu_torch.tools import scenario_sweep as ss
    made = []
    monkeypatch.setattr(ss, "gait_csv", lambda *a: made.append(a))
    missing = str(tmp_path / "arcdog.urdf")
    with pytest.raises(FileNotFoundError, match="arcdog"):
        ss.main(["--out", str(tmp_path / "sweep.json"), "--device", "cpu",
                 "--arcdog-urdf", missing])
    with pytest.raises(FileNotFoundError):
        ss.arcdog_models(str(tmp_path), "cpu")
    assert made == []


def test_loco_problem_defaults_to_cuda(mhpc_model, tmp_path):
    """`build_loco_problem` puts its plan on cuda unless asked for the CPU:
    without CUDA it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from cafempc_tpu_torch.problems import loco_problem as lp
    from cafempc_tpu_torch.reference import generator
    ref = generator.generate_reference("flypace", duration=0.3,
                                       model=mhpc_model)
    csv = str(tmp_path / "quad_reference.csv")
    generator.write_quad_reference_csv(ref, csv)
    cfg = mp.MHPCConfig(plan_dur_wb=0.2, plan_dur_srb=0.0, pcon_set="loco",
                        n_steps_max=32)
    with pytest.raises((RuntimeError, AssertionError)):
        lp.build_loco_problem(csv, mhpc_model, cfg=cfg, opts=SolverOptions())
    assert lp.build_loco_problem(csv, mhpc_model, cfg=cfg,
                                 opts=SolverOptions(), device="cpu")[2] \
        .step.active.device.type == "cpu"


def test_barrel_roll_solve_on_cpu_runs_the_twins_and_counts_no_launch(
        mhpc_model, tmp_path):
    """The barrel-roll solve on CPU tensors goes through the plain twins of
    the sweep and the linear rollout and launches nothing; its telemetry
    buffers hold `info_len` entries."""
    from cafempc_tpu_torch.problems import barrel_roll as br
    from cafempc_tpu_torch.reference.synthetic import \
        write_synthetic_br_settings
    from cafempc_tpu_torch.solver.hsddp import make_solver
    plan_np, pen_np, Xbar0, Ubar0, _ = br.build_barrel_roll_plan(
        write_synthetic_br_settings(str(tmp_path)))
    plan, pen, x0, Xbar0, Ubar0 = from_numpy(
        (plan_np, pen_np, br.initial_state(), Xbar0, Ubar0), "cpu",
        torch.float64)
    before = (sw.sweep.launches, lr.linroll.launches)
    res = make_solver(br.make_barrel_roll_fns(mhpc_model),
                      SolverOptions(max_AL_iter=1, max_DDP_iter=1),
                      fused_riccati=True, parallel_line_search=False,
                      max_resets=16, info_len=8)(
        plan, broadcast_batch(pen, 1), x0[None], Xbar0[None], Ubar0[None])
    assert bool(res.success.all()) and bool(torch.isfinite(res.cost).all())
    assert res.info.cost_buf.shape == (1, 8)
    assert (sw.sweep.launches, lr.linroll.launches) == before

"""Importing the port never loads jax, nor any module of the JAX package
`cafempc_tpu` (the GPU machine has no jax), and neither does calling its
HKD settings surface, AD partials and foot-Jacobian API."""
import os
import subprocess
import sys

import pytest

MODULES = [
    "cafempc_tpu_torch",
    "cafempc_tpu_torch.convert",
    "cafempc_tpu_torch.utils.rotations",
    "cafempc_tpu_torch.solver.options",
    "cafempc_tpu_torch.solver.plan",
    "cafempc_tpu_torch.solver.penalty",
    "cafempc_tpu_torch.solver.scan",
    "cafempc_tpu_torch.solver.hsddp",
    "cafempc_tpu_torch.models.hkd",
    "cafempc_tpu_torch.models.urdf",
    "cafempc_tpu_torch.models.synthetic_robot",
    "cafempc_tpu_torch.models.rbda",
    "cafempc_tpu_torch.models.wbm",
    "cafempc_tpu_torch.models.wb_lane",
    "cafempc_tpu_torch.models.srb",
    "cafempc_tpu_torch.reference.gait",
    "cafempc_tpu_torch.reference.quad_reference",
    "cafempc_tpu_torch.reference.synthetic",
    "cafempc_tpu_torch.reference.generator",
    "cafempc_tpu_torch.reference.acrobatic",
    "cafempc_tpu_torch.problems.hkd_problem",
    "cafempc_tpu_torch.ops._ext",
    "cafempc_tpu_torch.ops.sweep",
    "cafempc_tpu_torch.ops.linroll",
    "cafempc_tpu_torch.ops.hkd_table",
    "cafempc_tpu_torch.ops.hkd_lq",
    "cafempc_tpu_torch.ops.hkd_trial",
    "cafempc_tpu_torch.problems.hkd_fused",
    "cafempc_tpu_torch.problems.mhpc_problem",
    "cafempc_tpu_torch.problems.barrel_roll",
    "cafempc_tpu_torch.problems.loco_problem",
    "cafempc_tpu_torch.utils.traj_logging",
    "cafempc_tpu_torch.parallel.mesh",
    "cafempc_tpu_torch.parallel.knot_riccati",
    "cafempc_tpu_torch.runtime.warm_start",
    "cafempc_tpu_torch.runtime.staged",
    "cafempc_tpu_torch.runtime.mpc",
    "cafempc_tpu_torch.runtime.mhpc_runtime",
    "cafempc_tpu_torch.comms",
    "cafempc_tpu_torch.comms.lcm_wire",
    "cafempc_tpu_torch.comms.udpm",
    "cafempc_tpu_torch.comms.native",
    "cafempc_tpu_torch.examples",
    "cafempc_tpu_torch.examples.two_process_hkd_mpc",
    "cafempc_tpu_torch.examples.two_process_mhpc",
    "cafempc_tpu_torch.examples.barrel_roll_demo",
    "cafempc_tpu_torch.examples.loco_to_demo",
    "cafempc_tpu_torch.examples.br_reference_demo",
    "cafempc_tpu_torch.examples.hkd_mpc_demo",
    "cafempc_tpu_torch.viz",
    "cafempc_tpu_torch.viz.plots",
    "cafempc_tpu_torch.viz.animator",
    "cafempc_tpu_torch.tools",
    "cafempc_tpu_torch.tools.scenario_sweep",
]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# prints, after an import: <module> <jax loaded> <JAX package loaded>
_REPORT = ("print({m!r}, 'jax' in sys.modules, "
           "any(k.split('.')[0] == 'cafempc_tpu' for k in sys.modules))\n")


def _run(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)


@pytest.fixture(scope="module")
def loaded_after():
    """In one fresh interpreter, import the modules in order and record
    after each whether jax and the JAX package have been loaded."""
    code = "import sys, importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" + _REPORT.format(m=m)
        for m in MODULES)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    return {m: (j, p) for m, j, p in
            (line.split() for line in proc.stdout.splitlines())}


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out(loaded_after, module):
    assert loaded_after[module][0] == "False"


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_package_out(loaded_after, module):
    assert loaded_after[module][1] == "False"


def test_chip_smoke_imports_leave_jax_out():
    proc = _run("import sys, chip_smoke\n"
                + _REPORT.format(m="chip_smoke"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[1:] == ["False", "False"]


# the HKD surface of the port, called in a fresh interpreter on the CPU
_HKD_SURFACE = """
import sys, tempfile, torch
from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference, write_synthetic_hkd_settings)
from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
from cafempc_tpu_torch.solver.options import load_solver_options
x = torch.rand(3, 24, dtype=torch.float64)
c = torch.ones(3, 4, dtype=torch.float64)
hkd.dynamics_partials_ad(x, x, torch.full((3,), 0.01, dtype=x.dtype), c)
hkd.reset_map_partial_ad(x, c, 1 - c)
for leg in range(4):
    hkd.foot_jacobian(x[:, 3:6], x[:, 0:3], x[:, 12:15], leg)
    hkd.leg_fk_local(x[:, 12:15], leg)
with tempfile.TemporaryDirectory() as d:
    s = write_synthetic_hkd_settings(d) + "/HKDMPC/settings/"
    cfg = hp.load_hkd_constraint_params(s + "constraint_params.info",
                                        hp.HKDConfig(plan_duration=0.3,
                                                     n_steps_max=40))
    opts = load_solver_options(s + "ddp_setting.info")
qr = QuadReference(synthetic_bound_reference(duration=1.0))
qr.initialize(0.3)
pen = hp.build_hkd_plan(qr, cfg)[1]
hp.pen_to_device(pen, torch.float64, "cpu")
hp._facets(device="cpu")
HKDMPCRuntime(qr, cfg, opts, device="cpu")
"""


def test_hkd_surface_calls_leave_jax_out():
    proc = _run(_HKD_SURFACE + _REPORT.format(m="hkd_surface"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[1:] == ["False", "False"]

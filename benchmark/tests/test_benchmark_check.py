"""The check that decides `correct`, driven through whole runs of small
cells on the CPU (the harness's look for a card skipped by running on
`cpu`): sound runs come out correct; runs whose timed path is broken
underneath, the control (the reference in the next precision down, put
in the program's place) and the batched cells' planted fault come out
not correct.  The TF32 control of
the f32 batched cells exists only on the card (`cuda`)."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from benchmark import harness

BATCH = 4


# a cell whose workload file is kept for a later benchmark PR, without a
# BENCHMARK.json entry yet (PERF.md, Open questions)
KEPT = {"mhpc-replan-b1-f64": dict(config="mhpc", traffic="replan.b1")}


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    """A checkout whose BENCHMARK.json also lists the kept cells: the
    benchmark's files and BENCHMARK.json, copied, with their entries."""
    import json
    import shutil
    tmp = tmp_path_factory.mktemp("checkout")
    shutil.copytree(harness.HERE, tmp / "benchmark", ignore=shutil
                    .ignore_patterns("__pycache__", "tests"))
    bench = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    for name, entry in KEPT.items():
        bench["workloads"].append(dict(name=name, chips=1, why="kept",
                                       **entry))
        next(m for m in bench["end_to_end"]
             if m["name"] == "replan_ms_p50")["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def small(name, root, scenarios=BATCH):
    """The cell at a size a test run holds: a 0.3 s `hkd` plan (0.1 s SRB
    tail for `mhpc`), B=4, every scenario of two solves compared."""
    def ov(cell):
        p, c = cell.wl["params"], cell.cfg
        if cell.wl["driver"] == "batched":
            p.update(batch=BATCH, pool=3, warmup=1)
            cell.wl["check"].update(solves=2, scenarios=scenarios)
        else:
            p.update(warmup=1, gait_seconds=3.0)
            cell.wl["check"].update(updates=2)
        if c["problem"] == "hkd":
            c["settings"].update(plan_duration=0.3, n_steps_max=40)
        else:
            c["settings"].update(plan_dur_srb=0.1, n_steps_max=34)
    return harness.Cell(root, name, ov)


def run(name, root, device="cpu", control=False, fault=False, seconds=0.5,
        full=False):
    torch.set_num_threads(2)
    cell = harness.Cell(root, name) if full else small(name, root)
    return harness.run_cell(cell, 20251017, seconds, False,
                            time.perf_counter(), device=device,
                            control=control, fault=fault,
                            log=lambda m: None)


def tree_map(fn, tree):
    if isinstance(tree, tuple):
        vals = [tree_map(fn, t) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree) if torch.is_tensor(tree) else tree


def broken_solver(kind):
    """make_batched_solver whose solve is broken: `unchanged` returns its
    start (no outer iteration), `half` solves the first half of the
    batch and repeats it for the rest, `altered` hands every scenario its
    neighbour's answer, `final_step` drops the last AL iteration's step
    (its trajectory and cost, with the whole solve's gains)."""
    from cafempc_tpu_torch.parallel import mesh
    real = mesh.make_batched_solver

    def make(fns, opts, **kw):
        if kind == "unchanged":
            return real(fns, dataclasses.replace(opts, max_AL_iter=0), **kw)
        solve = real(fns, opts, **kw)
        if kind == "final_step":
            short = real(fns, dataclasses.replace(
                opts, max_AL_iter=opts.max_AL_iter - 1), **kw)
            return lambda *a: short(*a)._replace(K=solve(*a).K)

        def broken(plan, pen, x0, Xbar0, Ubar0):
            B = x0.shape[0]
            if kind == "half":
                h = B // 2
                res = solve(plan, tree_map(lambda t: t[:h], pen), x0[:h],
                            Xbar0[:h], Ubar0[:h])
                return tree_map(lambda t: torch.cat([t, t])[:B], res)
            return tree_map(lambda t: t.roll(1, 0), solve(plan, pen, x0,
                                                          Xbar0, Ubar0))
        return broken
    return make


def broken_runtime_solve(cls, kind):
    """cls._solve broken: `unchanged` keeps the previous solution (no
    re-solve after the first), `altered` shifts the solved controls by
    one step."""
    real = cls._solve

    def _solve(self, *args):
        if kind == "unchanged" and self.result is not None:
            self.timing = dict(build_ms=0.0, solve_ms=0.0, fetch_ms=0.0)
            return
        real(self, *args)
        if kind == "altered":
            if isinstance(self.result, dict):
                self.result["Ubar"] = np.roll(self.result["Ubar"], 1, 0)
            else:
                self.result = self.result._replace(
                    Ubar=np.roll(self.result.Ubar, 1, 0))
    return _solve


@pytest.mark.parametrize("name", ["hkd-b2048-f32", "mhpc-b256-f32",
                                  "hkd-replan-b1-f64", "mhpc-replan-b1-f64"])
def test_a_sound_run_is_correct(name, root):
    r = run(name, root)
    assert r["correct"], r["checks"]
    assert r["compared"] >= 2 and r["failed"] == 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered",
                                  "final_step"])
@pytest.mark.parametrize("name", ["hkd-b2048-f32", "mhpc-b256-f32"])
def test_a_broken_batched_solve_is_not_correct(name, kind, root,
                                               monkeypatch):
    from cafempc_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "make_batched_solver", broken_solver(kind))
    assert not run(name, root)["correct"]


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
@pytest.mark.parametrize("name", ["hkd-replan-b1-f64",
                                  "mhpc-replan-b1-f64"])
def test_a_broken_replan_is_not_correct(name, kind, root, monkeypatch):
    from cafempc_tpu_torch.runtime.mhpc_runtime import MHPCRuntime
    from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
    cls = HKDMPCRuntime if name.startswith("hkd") else MHPCRuntime
    monkeypatch.setattr(cls, "_solve", broken_runtime_solve(cls, kind))
    assert not run(name, root)["correct"]


@pytest.mark.parametrize("name", ["hkd-replan-b1-f64",
                                  "mhpc-replan-b1-f64"])
def test_the_f32_control_of_a_replan_is_not_correct(name, root):
    r = run(name, root, control=True)
    assert r["correct"]
    assert not held(r, "control_numbers"), r["control_numbers"]


@pytest.mark.parametrize("name", ["hkd-b2048-f32", "mhpc-b256-f32"])
def test_the_planted_fault_of_a_batched_cell_is_not_correct(name, root):
    """The reference after one AL iteration fewer, with the whole
    solve's gains, in the program's place."""
    r = run(name, root, fault=True)
    assert r["correct"], r["checks"]
    assert not held(r, "fault_numbers"), r["fault_numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hkd-b2048-f32", "mhpc-b256-f32"])
def test_the_tf32_control_of_a_batched_cell_is_not_correct(name, root,
                                                           cuda_device):
    """At the cell's own size: TF32 moves the gains by ~2e-4 only at
    full width and horizon."""
    r = run(name, root, device=cuda_device, control=True, seconds=3.0,
            full=True)
    assert r["correct"], r["checks"]
    assert not held(r, "control_numbers"), r["control_numbers"]


def held(r, key):
    """Whether the numbers `r[key]` hold the run's limits."""
    from benchmark import check
    return check.verdict(r[key], {k: v["limit"]
                                  for k, v in r["checks"].items()})[1]

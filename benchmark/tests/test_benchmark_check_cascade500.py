"""The check of the 500-step cascade cell (`cascade500-b128-f32`), driven
through whole runs on the CPU as `test_benchmark_check.py` drives the
other cells: a sound run is correct; runs whose solve is broken
underneath (its start returned unchanged, half the batch solved, answers
shifted by a scenario, the last AL iteration's step dropped) and the
planted fault in the program's place are not.  The runs keep the
configuration's whole 526-step plan and 32 resets a segment, at B=2 and
2 AL x 1 DDP (the fault drops the second AL iteration).  The TF32
control exists only on the card (`cuda`), at the cell's own size."""
import time

import pytest
import torch

from benchmark import harness
from test_benchmark_check import broken_solver, held

NAME = "cascade500-b128-f32"
BATCH = 2


def small():
    """The cell at a size a test run holds: B=2, 2 AL x 1 DDP, every
    scenario of the window's solves compared."""
    def ov(cell):
        cell.wl["params"].update(batch=BATCH, pool=2, warmup=1)
        cell.wl["check"].update(solves=2, scenarios=BATCH)
        cell.cfg["batched"]["opts"].update(max_AL_iter=2, max_DDP_iter=1)
    return harness.Cell(harness.HERE.parent, NAME, ov)


def run(device="cpu", control=False, fault=False, seconds=0.5, full=False):
    torch.set_num_threads(2)
    cell = harness.Cell(harness.HERE.parent, NAME) if full else small()
    return harness.run_cell(cell, 5300000023, seconds, False,
                            time.perf_counter(), device=device,
                            control=control, fault=fault,
                            log=lambda m: None)


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["compared"] >= BATCH and r["failed"] == 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered",
                                  "final_step"])
def test_a_broken_solve_is_not_correct(kind, monkeypatch):
    from cafempc_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "make_batched_solver", broken_solver(kind))
    r = run()
    assert not r["correct"], r["checks"]


def test_the_planted_fault_is_not_correct():
    """The reference after one AL iteration fewer, with the whole
    solve's gains, in the program's place."""
    r = run(fault=True)
    assert r["correct"], r["checks"]
    assert not held(r, "fault_numbers"), r["fault_numbers"]


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct(cuda_device):
    """At the cell's own size, on the card."""
    r = run(device=cuda_device, control=True, seconds=3.0, full=True)
    assert r["correct"], r["checks"]
    assert not held(r, "control_numbers"), r["control_numbers"]

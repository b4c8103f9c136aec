#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line of output each, unless noted):
  1. build the four CUDA kernels (`cafempc_tpu_torch/ops/csrc/*.cu`) with
     nvcc for sm_90a from this checkout, one nvcc per source in parallel,
     and print the build seconds;
  2. each kernel against its plain PyTorch twin on the card, f32 and f64,
     at the main path's shapes (B=256, N=112, xs=us=24): the sweep with
     transform steps and scenarios that fail the PSD check, the linear
     rollout, and the fused HKD LQ and trial kernels on the bench plan's
     operands perturbed from the seed (reset and padding steps, both
     branches of the relaxed barrier, per-scenario eps, scenarios blown up
     so that their trial is not ok); then the sweep and the linear rollout
     at the runtime's B=1 in f64 over 112 knots, and the linear rollout at
     the MHPC width xs=36 (B=37, N=33) in f32 and f64;
  3. the HKD-MPC bench default at full width: synthetic bound reference,
     1.0 s plan (112 steps), B=256 perturbed initial states, f32, 2 AL x 1
     DDP, sequential line search, reg floor 1e-3, the fused LQ and trial
     kernels, the sweep and linroll kernels; one warm-up solve, timed
     solves (CUDA events + a host fetch of cost and success), then one
     solve under torch.profiler for the device's busy time, with the
     launch counts set to 0 just before it and read just after (the
     kernels' launches per solve);
  3b. the same for the configuration without the fused LQ and trial
     (generic LQ and rollout, gathered resets, sweep and linroll kernels);
  4. the bench default with the plain twins of all four kernels, and the
     difference between the two solves;
  5. the MPC runtime: initialize + 5 updates at B=1, each fed the solver's
     own predicted state;
  6. the whole-body and SRB model layer (`models/{rbda, wbm, wb_lane,
     srb}`, plain PyTorch, no hand kernel) at the `mhpc` config's batch on
     the synthetic quadruped: the WB linearization `wb_dyn_partials_lane`
     on 256 x 25 knots, the WB step, the impulse partials on 256 x 4 reset
     knots and the SRB partials on 256 x 10 tail knots, in f32 and f64;
     checks: (a) the card against the CPU in f64 on 64 knots, (b) the
     lane form against the per-knot `wbm` in f64, (c) the reference's
     kinematics derivatives and (d) SRB derivatives from
     `tests/fixtures/`, (e) f32 against f64; then the median ms per call,
     knots/s, launches, device busy ms and idle share of one call, and the
     phase's peak device memory (two lines);
  7. the MHPC cascade (`problems/mhpc_problem.py`, segmented solve) on the
     synthetic quadruped and the urdf-order synthetic bound reference with
     the in-code default settings:
     a. the `mhpc` bench configuration (the JAX package's bench.py:87-110):
        B=256, f32, 25 WB + 10 SRB knots, 4 AL x 1 DDP, sequential line
        search, 16 resets per segment, reg floor 1e-3, through the sweep
        and linroll kernels: one warm-up solve (keeping the first sweep's
        and linroll's operands), timed solves, one solve profiled on the
        device with the launch counts set to 0 just before and read just
        after; a scenario that fails is solved again in f64; the same
        solve through the plain twins (equal success flags, cost within
        COST_RTOL); then the two kernels against their twins on the
        captured operands (f64 to 1e-10), their ms per launch and bound;
     b. MHPCRuntime at B=1 in f64: initialize + 3 updates, each fed the
        solver's predicted state one MPC period ahead, each step's host
        plan build, solve and fetch ms;
     c. one solve of the `cascade500` configuration (bench.py:113-147):
        B=128, f32, 250 WB + 250 SRB knots, 32 resets per segment;
  8. the serving path, sim <-> MPC <-> C++ consumer over LCM UDP multicast
     on loopback (ttl 0), the MPC server in this process on the card:
     a. every LCM type (and a 92,816-byte wbTraj_lcmt in LC03 fragments)
        from the Python transport to the native one and back, bytes equal;
     b. HKDMPCRuntime at phase 5's configuration serving the sim role of
        `cafempc_tpu_torch.examples.two_process_hkd_mpc` (a subprocess on
        the CPU) for 20 MPC steps, one serve(max_msgs=1) a step with the
        launch counts set to 0 just before and read just after (the sweep
        and linroll must launch on every served solve), while the C++
        `hkd_command_listener` (a subprocess) decodes 10 commands; the
        sim's height check must hold and the last command equal the
        runtime's `command_message` after the f32 cast; per step the
        latency (state published -> command received, from the sim) and
        the runtime's build / solve / fetch ms;
     c. 5 states queued, then one serve(max_msgs=1): one solve, on the
        newest (its command's mpc_times[0] is that state's mpctime);
     d. MHPCRuntime at phase 7b's configuration with debug_intermtraj
        serving the sim role of `two_process_mhpc` for init + 3 updates: a
        client counts solver_info (one per solve) and intermediate
        trajectories (one per AL iteration) and checks the last command;
  9. the offline trajectory-optimization path on the synthetic quadruped,
     f64 unless noted:
     a. the reference generator and the acrobatic references on the card
        (trot 1.5 s, pace 1.0 s, flypace 1.2 s, the in-place barrel roll,
        the run-jump with 2 bounds either side): stance feet on their
        targets to 1e-8, the CSV round trip's contacts equal, the roll
        ending at 2 pi, one run-jump flight longer than 0.3 s; the seconds
        of each;
     b. the barrel-roll TO (131 knots, 5 resets) at B=1 on the synthetic
        settings (`write_synthetic_br_settings`), 2 AL x 4 DDP (BR_OPTS),
        16 gathered resets, through the sweep and linroll kernels: one
        warm-up solve, one timed solve with the launch counts set to 0
        just before and read just after; then the plain-twin solve (equal
        success and iteration counts, cost within 1e-8 relative); then
        one solve by stage (a synchronizing timer around each problem
        function and kernel wrapper) and one WB linearization's device
        profile;
     c. both kernels against their twins on 9b's first sweep and linroll
        operands (f64, 1e-10, equal ok flags), their ms per launch, twin
        ms and bound;
     d. the barrel roll under pushes: B=64, f32, the body's linear
        velocity perturbed by N(0, 0.2^2) m/s per axis (seed 0), 2 AL x 2
        DDP: ms per batched solve, successes (failures solved again in
        f64), launches, idle share, peak memory; the twin solve (equal
        success flags and iteration counts, cost within COST_RTOL);
     e. the locomotion TO on 9a's flypace CSV: 1.0 s of WB knots, the
        MHPC in-code default weights with the loco constraint set, 2 AL x
        4 DDP;
     f. the MHPC cascade over the in-place barrel-roll reference (with
        the reference data's timing) in the window [0.25, 0.85] s, 4 AL:
        a discovered flight phase, the touchdown AL armed at its terminal
        knot, success with a finite cost, the largest roll angle;
 10. the JAX package's default solver configuration (masked resets, the
     exact sequential sweep, the scan linear rollout, the batched line
     search) and the solver's other plain-PyTorch stages:
     a. phase 3b's hkd-B256-f32 plan under `make_batched_solver(fns, opts,
        trim_output=True, reg_floor=1e-3)`, then with parallel_riccati:
        one warm-up, timed solves, one profiled solve; no kernel launch,
        success flags equal to 3b's, cost within COST_RTOL;
     b. the sweep kernel, the exact sequential sweep and the scan sweep at
        B=1 in f64 on the HKD runtime plan's first sweep operands and on
        9b's: all ok, each against the exact sweep to PLAIN_SWEEP_TOL,
        profiler device ms and CUDA-event ms per call;
     c. single shooting (opts.MS=False, all_shooting=False) on the HKD
        runtime plan at B=1 in f64, 2 AL x 3 DDP: success, feas < 1e-8,
        the final cost at or below the first;
     d. 7a's mhpc-B256-f32 solve with masked resets and the batched line
        search, the sweep and linroll kernels kept: success flags equal to
        7a's, cost within COST_RTOL, peak memory;
     e. 7c's cascade500 solve cut to 1 AL x 1 DDP, unchunked and with
        lq_knot_chunk=16: ms and peak memory of each, success flags equal,
        cost within COST_RTOL; the chunked LQ stage against the unchunked
        one on the plan's initial trajectory at B=2, f64 to 1e-12 and f32
        to 1e-4, normalized;
     f. 9b's barrel roll under the JAX demo's configuration (the
        make_solver defaults): success and iteration counts equal to 9b's,
        cost within 1e-6 relative;
 11. the batched scenario sweep (BASELINE config 5,
     `cafempc_tpu_torch/tools/scenario_sweep.py`) and the scale-out layer
     (`parallel/{mesh, knot_riccati}.py`), f32 unless noted:
     a. the `mhpc` sweep's warm-started MPC chain (the tool's
        `run_case_chain`) on a bound gait generated on the synthetic
        quadruped (2.0 s): window 0.75 s (25 WB + 10 SRB knots), 2 plans a
        scenario, chunk 256, 4 AL x 1 DDP, pushes N(0, 0.25^2) m/s on the
        body's linear velocity, noise 0.02, total 512 (one warm-up chunk,
        one timed chunk, the launch counts set to 0 as the timed window
        opens and read after it): success rate, cost p50/p95, feasibility
        by chain step, solves/s, iterations, launches, peak memory; all
        costs and propagated states finite; then the chain at B=8 through
        the kernels and through their twins (equal success flags and
        iteration counts, cost within COST_RTOL);
     b. the `hkd` sweep (`run_case`, the JAX defaults, 2 AL x 1 DDP) on
        the same gait, chunk 256, a warm-up and a timed chunk;
     c. the knot-sharded sweep at B=1 in f64 on 10b's operands (the HKD
        runtime plan; 9b's barrel roll), 4 knot blocks on the one card:
        against the exact sweep to PLAIN_SWEEP_TOL, device ms, launches
        and CUDA-event ms per call beside 10b's scan sweep; then the
        exact, scan and knot sweeps in f32 on the same operands, their
        gains against the f64 exact sweep's;
     d. 3b's plan and keywords with the knot-sharded sweep in place of the
        sweep kernel over `scenario_knot_mesh(1, 4)` of the card, against
        the same keywords with parallel_riccati and no mesh: equal success
        flags and iterations, cost within COST_RTOL, ms per solve;
     e. 3b's solve through `scenario_mesh()`: bit for bit 3b's;
 12. the MHPC joint mode and the last ported modules (sub-phases d-f):
     d. the same solve with the joint-mode functions (`make_mhpc_fns(cfg,
        model)`, every knot evaluating both models): a warm-up keeping the
        first sweep and linroll operands, one profiled solve against 7a's,
        then both kernels against their twins on those operands (f64 to
        1e-10, ok flags equal), their ms, twin ms and bound;
     e. MHPCRuntime(segmented=False) on 7b's states: commands against 7b's
        to RT_RTOL, each step's build, solve and fetch ms;
     f. the HKD-MPC demo's closed loop (`examples/hkd_mpc_demo.py` without
        the plots) on a pace generated on the card, 10 MPC steps: height
        in (0.05, 0.6) m, finite costs, ms per update;
 13. the JAX package's last HKD surface and config 5's arcdog half, on
     stand-in settings files that `write_synthetic_hkd_settings` writes
     from the in-code defaults (sub-phases a, c and d):
     a. phase 3's bench default built as the JAX bench builds it
        (bench.py:58-84): `load_hkd_constraint_params`,
        `load_solver_options` cut to 2 AL x 1 DDP, `pen_to_device`; timed
        solves, launches per solve, one profiled solve, then against phase
        3's solve (success flags and iteration counts per scenario equal,
        cost within COST_RTOL);
     c. `HKDMPCRuntime(qr, cfg, opts)` with no device argument, from the
        files, initialize + 3 updates on phase 5's states: its solves on
        the card, commands within 1e-10 of phase 5's;
     d. the arcdog half of the `mhpc` sweep (the tool's `--arcdog-urdf`
        path) given the synthetic quadruped's URDF as a stand-in for the
        arcdog's: both arcdog gaits generated on the card, chains of 2
        plans, chunks of 64, 11a's keywords: solves/s, success rate, the
        sweep's and linroll's launches; every cost and propagated state
        finite;
each phase's wall seconds (a `[t]` line after it), then the card's name
and power limit, one JSON line of the kernels (`launches` each one's
launches in phase 3's profiled solve, `ms` its device time per launch by
torch.profiler, `event_ms` its CUDA-event time per wrapper call, host work
included, and its bound: bytes over the HBM rate or operations over the
f32 peak, whichever is larger; for the sweep and linroll the same figures
at phase 7a's shape under `mhpc`, launches per profiled solve, under
`sweep_chain` with 11a's launches in its timed chunk (the same shape),
under `mhpc_joint` at 12d's (the same shape, launches in its profiled
solve), and at phase 9b's under `barrel_roll`, f64, launches per solve,
bound by the f64 peak) and the final `{"ok": true, "device": ...}` line.
Exits non-zero, printing no result, without a CUDA device or when any phase
fails.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from cafempc_tpu_torch import convert
from cafempc_tpu_torch.comms import lcm_wire as wire
from cafempc_tpu_torch.comms import native
from cafempc_tpu_torch.comms.udpm import (DEFAULT_ADDR, LCMEndpoint,
                                          UDPMulticast, frame)
from cafempc_tpu_torch.examples import barrel_roll_demo as ex_br
from cafempc_tpu_torch.examples import br_reference_demo as ex_brref
from cafempc_tpu_torch.examples import hkd_mpc_demo as ex_demo
from cafempc_tpu_torch.examples import loco_to_demo as ex_loco
from cafempc_tpu_torch.examples import two_process_hkd_mpc as ex_hkd
from cafempc_tpu_torch.examples import two_process_mhpc as ex_mhpc
from cafempc_tpu_torch.models import hkd, rbda, srb, synthetic_robot, wb_lane
from cafempc_tpu_torch.models import wbm
from cafempc_tpu_torch.ops import _ext
from cafempc_tpu_torch.ops import hkd_lq as hkd_lq_mod
from cafempc_tpu_torch.ops import hkd_trial as hkd_trial_mod
from cafempc_tpu_torch.ops import linroll as linroll_mod
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.parallel import mesh as mesh_mod
from cafempc_tpu_torch.parallel.mesh import broadcast_batch, make_batched_solver
from cafempc_tpu_torch.problems import barrel_roll as br
from cafempc_tpu_torch.problems import hkd_fused as hf
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.problems import loco_problem as lp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference import acrobatic, generator
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        load_quad_reference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.reference.synthetic import (
    synthetic_bound_reference, synthetic_bound_reference_urdf,
    write_synthetic_br_settings, write_synthetic_hkd_settings)
from cafempc_tpu_torch.runtime.mhpc_runtime import MHPCRuntime
from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
from cafempc_tpu_torch.solver import hsddp
from cafempc_tpu_torch.solver.hsddp import make_solver
from cafempc_tpu_torch.solver.options import (SolverOptions,
                                              load_solver_options)
from cafempc_tpu_torch.tools import scenario_sweep as ss

DEVICE = "cuda"
B = 256
PLAN_DURATION = 1.0
N_STEPS = 112
N_TIMED = 5
SEED = 0
# kernel vs plain-twin solve in f32: the sweep's sums are reassociated
# along the 112-knot recursion, and the line search carries the difference
COST_RTOL = 1e-3
MAX_RESETS = 16
# the card's peaks for the bounds (published H100 SXM figures at 700 W):
# HBM bytes/s and float32 FLOP/s outside the tensor cores (an FMA is 2)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# float64 FLOP/s outside the tensor cores (NVIDIA's H100 SXM data sheet)
PEAK_F64 = 34e12
# the kernels' wrappers and their launch counters
KERNELS = {"sweep": sweep_mod.sweep, "linroll": linroll_mod.linroll,
           "hkd_lq": hkd_lq_mod.hkd_lq, "hkd_trial": hkd_trial_mod.hkd_trial}


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sweep_inputs(gen, dtype, batch, n_fail=8):
    """Seeded Riccati-sweep operands at the main path's widths (N=112,
    xs=us=24) for `batch` scenarios, with every fifth step a transform step
    and `n_fail` scenarios whose control Hessian is negative definite at
    one dynamics step (so that the PSD check must flag them)."""
    xs = us = 24
    dev = DEVICE

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, dtype=torch.float64)
                * s).to(dev, dtype)

    def spd(n, s):
        M = rnd(batch, N_STEPS, n, n, s=0.3)
        return M @ M.transpose(-1, -2) + s * torch.eye(n, device=dev,
                                                       dtype=dtype)

    A = torch.eye(xs, device=dev, dtype=dtype) + rnd(batch, N_STEPS, xs, xs,
                                                     s=0.02)
    Bm = rnd(batch, N_STEPS, xs, us, s=0.05)
    lxx, luu = spd(xs, 0.5), spd(us, 1.0)
    luu[:n_fail, N_STEPS // 2] = -torch.eye(us, device=dev, dtype=dtype)
    w = torch.zeros(N_STEPS, dtype=torch.int32, device=dev)
    w[::5] = 1
    phixx = rnd(batch, xs, xs, s=0.3)
    return (A, Bm, rnd(batch, N_STEPS, xs, s=0.5),
            rnd(batch, N_STEPS, us, s=0.5), lxx, luu,
            rnd(batch, N_STEPS, us, xs, s=0.05), rnd(batch, xs, s=0.5),
            phixx @ phixx.transpose(-1, -2),
            rnd(batch, N_STEPS + 1, xs, s=0.01), w,
            torch.full((batch,), 1e-3, device=dev, dtype=dtype))


def errors(a, b, mask):
    """(max |a - b|, max |a - b| / max |b|) over the scenarios in mask."""
    a, b = a[mask], b[mask]
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-30)


def time_ms(fn, n):
    """CUDA-event ms per call over n back-to-back calls (the wrapper's host
    work included where it exceeds the device's)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def kernel_ms(fn, n, kernel, tries=5):
    """Device ms per launch of the CUDA kernel whose name contains `kernel`,
    by torch.profiler over runs of n calls of fn: summed over the launches
    it recorded by name, divided by their count.  A run has been seen to
    come back with some of its launches missing (4 of 20 once), so runs
    are repeated, up to `tries`, until n // 2 launches were recorded."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    us = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us += [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel in e.name]
        if len(us) >= n // 2:
            return sum(us) / len(us) / 1e3
    fail(f"the profiler saw {len(us)} launches of {kernel} in {tries} runs "
         f"of {n}")


def both_ms(fn, n, kernel):
    """(profiler kernel ms, CUDA-event ms per call) of one wrapper."""
    return kernel_ms(fn, n, kernel), time_ms(fn, n)


def nbytes(inputs, outputs):
    """Bytes a kernel must move: each tensor input read once, each output
    written once."""
    return sum(t.numel() * t.element_size() for t in (*inputs, *outputs)
               if torch.is_tensor(t))


def bound(n_bytes, flops, peak=PEAK_F32):
    """(least ms on the card, which bound) from bytes over the HBM rate
    and operations over the CUDA cores' peak for their type (`peak`)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_flops(ins):
    """Operations of one sweep on these operands (an FMA is 2), counting
    dynamics and transform steps from this run's w."""
    A, lu, w = ins[0], ins[3], ins[10]
    Bsz, N, xs = A.shape[:3]
    us = lu.shape[-1]
    n_tr = int((w > 0).sum())
    # H'^T [A B], Gn, [Qx Qu], Qxx, Qux, Quu, Cholesky, 1 + xs solves,
    # G and H updates
    dyn = (xs * xs * (xs + us) + xs * xs + (xs + us) * xs + xs ** 3
           + 2 * us * xs * xs + us * us * xs + us ** 3 / 6
           + (1 + xs) * us * us + xs * us)
    tr = 2 * xs ** 3 + 2 * xs * xs    # H'^T A, Gn, Qx, Qxx
    return 2.0 * Bsz * ((N - n_tr) * dyn + n_tr * tr)


def check_sweep_b1(label):
    """The sweep kernel against its twin for one scenario (the runtime's
    B=1) over N=112 knots in f64."""
    ins = sweep_inputs(torch.Generator().manual_seed(SEED + 2),
                       torch.float64, 1, n_fail=0)
    got = sweep_mod.sweep(*ins)
    want = sweep_mod.sweep_reference(*ins)
    torch.cuda.synchronize()
    if not (float(got[7][0]) == float(want[7][0]) == 1.0):
        fail("the B=1 f64 sweep is not ok in the kernel or the twin")
    every = torch.ones(1, dtype=torch.bool, device=DEVICE)
    errs = {n: errors(got[i], want[i], every)
            for i, n in ((0, "G"), (1, "H"), (2, "K"), (3, "dU"),
                         (8, "dv"))}
    worst = max(e[1] for e in errs.values())
    ms = time_ms(lambda: sweep_mod.sweep(*ins), 50)
    print(f"[2] sweep kernel vs twin B=1 N={N_STEPS} float64: max err (abs, "
          "normalized by max abs) " + " ".join(
              f"{k}=({a:.3e}, {r:.3e})" for k, (a, r) in errs.items())
          + f"; ok in both (tol 1e-10); kernel {ms:.4f} ms [{label}]",
          flush=True)
    if not worst <= 1e-10:
        fail(f"the B=1 f64 sweep disagrees with its twin: {worst:.3e}")


# (B, N, xs, dtype, tolerance): the runtime's single scenario over the
# bench plan's 112 knots, and the MHPC width at an odd batch and length
LINROLL_CASES = [(1, N_STEPS, 24, torch.float64, 1e-10),
                 (37, 33, 36, torch.float32, 1e-4),
                 (37, 33, 36, torch.float64, 1e-10)]


def check_linroll_shapes(label):
    """The linroll kernel against its twin at LINROLL_CASES' shapes, on
    seeded operands whose N-step products stay bounded, with its profiler
    time per launch."""
    for i, (Bsz, N, xs, dtype, tol) in enumerate(LINROLL_CASES):
        gen = torch.Generator().manual_seed(SEED + 3 + i)

        def rnd(*shape, s):
            return (torch.randn(*shape, generator=gen, dtype=torch.float64)
                    * s).to(DEVICE, dtype)

        args = (rnd(Bsz, N, xs, xs, s=0.8 / xs ** 0.5), rnd(Bsz, N, xs, s=0.1),
                rnd(Bsz, xs, s=1.0))
        got = linroll_mod.linroll(*args)
        want = linroll_mod.linroll_reference(*args)
        torch.cuda.synchronize()
        err, rel = errors(got, want, torch.ones(Bsz, dtype=torch.bool,
                                                device=DEVICE))
        ms = kernel_ms(lambda: linroll_mod.linroll(*args), 50,
                       "linroll_kernel")
        print(f"[2] linroll kernel vs twin B={Bsz} N={N} xs={xs} "
              f"{str(dtype)[6:]}: max err (abs, normalized by max abs) "
              f"({err:.3e}, {rel:.3e}) (tol {tol:g}); kernel {ms:.4f} ms by "
              f"the profiler [{label}]", flush=True)
        if not rel <= tol:
            fail(f"linroll disagrees with its twin at B={Bsz} N={N} xs={xs} "
                 f"in {dtype}: {rel:.3e}")


def phase_kernels(label):
    """Kernel vs twin in f32 and f64; returns the f32 figures."""
    f32 = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        gen = torch.Generator().manual_seed(SEED)
        ins = sweep_inputs(gen, dtype, B)
        got = sweep_mod.sweep(*ins)
        want = sweep_mod.sweep_reference(*ins)
        torch.cuda.synchronize()
        ok_k, ok_r = got[7] > 0.5, want[7] > 0.5
        if not torch.equal(ok_k, ok_r):
            fail(f"sweep ok flags differ ({dtype})")
        n_bad = int((~ok_k).sum())
        if n_bad != 8:
            fail(f"expected 8 PSD-failing scenarios, kernel flagged {n_bad}")
        errs = {n: errors(got[i], want[i], ok_k)
                for i, n in ((0, "G"), (1, "H"), (2, "K"), (3, "dU"),
                             (8, "dv"))}
        M = ins[0] + ins[1] @ got[2]
        c = torch.randn(B, N_STEPS, 24, generator=gen,
                        dtype=torch.float64).to(DEVICE, dtype) * 0.01
        dx0 = ins[9][:, 0].contiguous()
        dX = linroll_mod.linroll(M.contiguous(), c, dx0)
        dX_ref = linroll_mod.linroll_reference(M, c, dx0)
        errs["dX"] = errors(dX, dX_ref, ok_k)
        worst = max(e[1] for e in errs.values())
        print(f"[2] kernel vs twin {str(dtype)[6:]}: max err (abs, "
              "normalized by max abs) "
              + " ".join(f"{k}=({a:.3e}, {r:.3e})"
                         for k, (a, r) in errs.items())
              + f"; ok flags equal, {n_bad} PSD-failing scenarios flagged "
              f"by both (tol {tol:g})", flush=True)
        if not worst <= tol:
            fail(f"kernel disagrees with its twin in {dtype}: {worst:.3e}")
        if dtype == torch.float32:
            f32["sweep_err"] = max(errs[k][0] for k in ("G", "H", "K", "dU",
                                                        "dv"))
            f32["linroll_err"] = errs["dX"][0]
            f32["sweep_bound"] = bound(nbytes(ins, got), sweep_flops(ins))
            f32["sweep_ms"], f32["sweep_event_ms"] = both_ms(
                lambda: sweep_mod.sweep(*ins), 20, "sweep_kernel")
            f32["sweep_plain_ms"] = time_ms(
                lambda: sweep_mod.sweep_reference(*ins), 2)
            args = (M.contiguous(), c, dx0)
            # dX[k+1] = M[k] dX[k] + c[k]: one FMA per entry of M
            f32["linroll_bound"] = bound(nbytes(args, (dX,)),
                                         2.0 * M.numel() + c.numel())
            f32["linroll_ms"], f32["linroll_event_ms"] = both_ms(
                lambda: linroll_mod.linroll(*args), 50, "linroll_kernel")
            f32["linroll_plain_ms"] = time_ms(
                lambda: linroll_mod.linroll_reference(*args), 5)
    print(f"[2] f32 times at B={B} N={N_STEPS} xs=us=24 ({label}), kernel "
          f"ms by the profiler (CUDA events per wrapper call): sweep "
          f"{f32['sweep_ms']:.4f} ({f32['sweep_event_ms']:.4f}) vs twin "
          f"{f32['sweep_plain_ms']:.3f} ms; linroll "
          f"{f32['linroll_ms']:.4f} ({f32['linroll_event_ms']:.4f}) vs twin "
          f"{f32['linroll_plain_ms']:.3f} ms", flush=True)
    return f32


def hkd_operands(gen, dtype, problem):
    """Seeded operands of the fused HKD LQ and trial kernels on the bench
    plan: states, controls and penalties perturbed from the plan's, ground
    forces spread across the relaxed barrier's threshold (both branches
    active), AL terms on at half the terminal knots' legs, per-scenario
    eps in (0.05, 1], and scenarios 0-1 (huge) and 2-3 (infinite) blown
    up in the search direction, so that their trial is not ok."""
    plan, pen, _, Xbar0, Ubar0 = problem
    dev, f64 = DEVICE, torch.float64

    def rnd(*shape, s):
        return (torch.randn(*shape, generator=gen, dtype=f64) * s).to(
            dev, dtype)

    def uni(*shape, lo, hi):
        return (torch.rand(*shape, generator=gen, dtype=f64) * (hi - lo)
                + lo).to(dev, dtype)

    NK, N = N_STEPS + 1, N_STEPS
    term = plan.knot.is_terminal[None, :, None] > 0
    d = dict(
        X=Xbar0 + rnd(B, NK, 24, s=0.05), U=Ubar0 + rnd(B, N, 24, s=0.3),
        reb_delta=pen.reb_delta * uni(B, N, 20, lo=1.0, hi=1.5),
        reb_eps=pen.reb_eps * uni(B, N, 20, lo=1.0, hi=2.0),
        reb_act=pen.reb_active, al_lam=rnd(B, NK, 4, s=1.0),
        al_sig=pen.al_sigma * uni(B, NK, 4, lo=1.0, hi=2.0),
        al_act=torch.maximum(pen.al_active, (term & (
            uni(B, NK, 4, lo=0.0, hi=1.0) < 0.5)).to(dtype)),
        eps=uni(B, lo=0.05, hi=1.0), dX=rnd(B, NK, 24, s=0.02),
        dUK=rnd(B, N, 24, s=0.1))
    d["x0"] = d["X"][:, 0] + rnd(B, 24, s=0.01)
    d["dX"][0:2, 3] = 1e7
    d["dX"][2:4, 7] = float("inf")
    return d


LQ_IN = ("X", "U", "reb_delta", "reb_eps", "reb_act", "al_lam", "al_sig",
         "al_act")
TRIAL_IN = ("eps", "x0", "X", "dX", "U", "dUK") + LQ_IN[2:]


def phase_hkd_kernels(label):
    """The fused HKD LQ and trial kernels against their twins in f32 and
    f64 on the bench plan; returns the f32 figures."""
    f32 = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        problem, _ = bench_problem(dtype)
        plan = problem[0]
        n_reset = int(plan.step.is_reset.sum())
        n_pad = int((plan.step.active == 0).sum())
        if not (n_reset and n_pad):
            fail("the bench plan has no reset or no padding step")
        d = hkd_operands(torch.Generator().manual_seed(SEED + 1), dtype,
                         problem)
        table = hf.knot_table(plan)
        on = d["reb_act"] > 0
        g = hkd_lq_mod.friction_values(d["U"], hp.MU_FRIC)
        n_log = int((g[on] > d["reb_delta"][on]).sum())
        n_quad = int((g[on] <= d["reb_delta"][on]).sum())
        if not (n_log and n_quad):
            fail("the ReB operands do not reach both barrier branches")
        lq_args = [d[k] for k in LQ_IN] + [table, hp.MU_FRIC]
        tr_args = [d[k] for k in TRIAL_IN] + [table, hp.MU_FRIC]
        got_lq = hkd_lq_mod.hkd_lq(*lq_args)
        want_lq = hkd_lq_mod.hkd_lq_reference(*lq_args)
        got_tr = hkd_trial_mod.hkd_trial(*tr_args)
        want_tr = hkd_trial_mod.hkd_trial_reference(*tr_args)
        torch.cuda.synchronize()
        ok_k, ok_r = got_tr[-1] > 0.5, want_tr[-1] > 0.5
        if not torch.equal(ok_k, ok_r):
            fail(f"hkd_trial ok flags differ ({dtype})")
        n_bad = int((~ok_k).sum())
        if n_bad != 4:
            fail(f"expected 4 blown-up trials, the kernel flagged {n_bad}")
        every = torch.ones(B, dtype=torch.bool, device=DEVICE)
        errs = {f"lq.{n}": errors(a, b, every) for n, a, b in zip(
            ("A", "B", "lx", "lu", "lxx", "luu", "phix", "phixx"), got_lq,
            want_lq)}
        errs.update({f"trial.{n}": errors(a, b, ok_k) for n, a, b in zip(
            ("X", "U", "Xsim", "Defect", "g", "h", "cq", "cost", "feas",
             "maxp", "maxt"), got_tr, want_tr)})
        worst = max(e[1] for e in errs.values())
        print(f"[2] hkd kernels vs twins {str(dtype)[6:]}: max err (abs, "
              "normalized by max abs) "
              + " ".join(f"{k}=({a:.3e}, {r:.3e})"
                         for k, (a, r) in errs.items())
              + f"; {n_reset} reset and {n_pad} padding steps, ReB active "
              f"entries on the log / quadratic branch {n_log} / {n_quad}; "
              f"ok flags equal, {n_bad} blown-up trials flagged by both "
              f"(tol {tol:g})", flush=True)
        if not worst <= tol:
            fail(f"an hkd kernel disagrees with its twin in {dtype}: "
                 f"{worst:.3e}")
        if dtype == torch.float32:
            f32["hkd_lq_err"] = max(v[0] for k, v in errs.items()
                                    if k.startswith("lq."))
            f32["hkd_trial_err"] = max(v[0] for k, v in errs.items()
                                       if k.startswith("trial."))
            # bytes only: their per-knot arithmetic is not counted (an op
            # bound above the byte bound would need ~10^5 operations per
            # knot for the LQ and ~10^4 for the trial)
            f32["hkd_lq_bound"] = bound(nbytes(lq_args, got_lq), 0.0)
            f32["hkd_trial_bound"] = bound(nbytes(tr_args, got_tr), 0.0)
            f32["hkd_lq_ms"], f32["hkd_lq_event_ms"] = both_ms(
                lambda: hkd_lq_mod.hkd_lq(*lq_args), 20, "hkd_lq_kernel")
            f32["hkd_lq_plain_ms"] = time_ms(
                lambda: hkd_lq_mod.hkd_lq_reference(*lq_args), 5)
            f32["hkd_trial_ms"], f32["hkd_trial_event_ms"] = both_ms(
                lambda: hkd_trial_mod.hkd_trial(*tr_args), 50,
                "hkd_trial_kernel")
            f32["hkd_trial_plain_ms"] = time_ms(
                lambda: hkd_trial_mod.hkd_trial_reference(*tr_args), 5)
    print(f"[2] f32 times at B={B} N={N_STEPS} ({label}), kernel ms by the "
          f"profiler (CUDA events per wrapper call): hkd_lq "
          f"{f32['hkd_lq_ms']:.4f} ({f32['hkd_lq_event_ms']:.4f}) vs twin "
          f"{f32['hkd_lq_plain_ms']:.3f} ms; hkd_trial "
          f"{f32['hkd_trial_ms']:.4f} ({f32['hkd_trial_event_ms']:.4f}) vs "
          f"twin {f32['hkd_trial_plain_ms']:.3f} ms", flush=True)
    return f32


def bench_problem(dtype, cfg=None, pen_to_device=False):
    """The bench `hkd` configuration (JAX package bench.py:58-84) on the
    synthetic bound reference: plan, penalties, B perturbed x0 and the
    initial trajectory, plus the plan's phase metadata.  cfg: the
    HKDConfig (default: the in-code one at the bench's plan);
    pen_to_device: convert the penalties by `hp.pen_to_device`, as the JAX
    bench does (else with the plan, by `convert.from_numpy`)."""
    qr = QuadReference(synthetic_bound_reference(duration=2.0))
    qr.initialize(PLAN_DURATION)
    cfg = cfg or hp.HKDConfig(plan_duration=PLAN_DURATION,
                              n_steps_max=N_STEPS)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(qr, cfg)
    body = np.zeros(12)
    body[5] = 0.2486
    f64 = torch.float64
    qd = hkd.compute_hkd_state(
        torch.tensor(body[0:3], dtype=f64), torch.tensor(body[3:6], dtype=f64),
        torch.tensor([0.0, -0.8, 1.6] * 4, dtype=f64),
        torch.tensor(meta["phases"][0][3], dtype=f64))
    x0 = torch.cat([torch.tensor(body, dtype=f64), qd])
    gen = torch.Generator().manual_seed(SEED)
    x0_b = x0[None] + 0.01 * torch.randn(B, 24, generator=gen, dtype=f64)
    plan, Xbar0, Ubar0 = convert.from_numpy((plan_np, Xbar0, Ubar0),
                                            DEVICE, dtype)
    pen = (hp.pen_to_device(pen_np, dtype, DEVICE) if pen_to_device
           else convert.from_numpy(pen_np, DEVICE, dtype))
    return (plan, broadcast_batch(pen, B), x0_b.to(DEVICE, dtype),
            broadcast_batch(Xbar0, B), broadcast_batch(Ubar0, B)), meta


def timed_solves(solve, args, n, warmup=True):
    """One warm-up solve (unless warmup=False), then n solves each timed
    with CUDA events around the solve and the host fetch of (cost,
    success)."""
    if warmup:
        solve(*args)
    ms = []
    for _ in range(n):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        res = solve(*args)
        cost, success = res.cost.cpu(), res.success.cpu()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return res, cost, success, ms


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def profile_device(fn, host=True, kernels=()):
    """fn() under torch.profiler, fn ending in a host fetch: (kernel
    launches, other device ops (copies, fills), device busy ms, wall ms,
    the five device ops with the most time as (name, ms, count), and for
    each name in `kernels` the (ms, count) of the device ops whose name
    contains it), or None where the profiler saw no device activity.
    host=False records the device's activity only: for a call of thousands
    of small ops it costs seconds less to read back and adds less to the
    wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if host:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(((k[:48], ms, n) for k, (ms, n) in by_name.items()),
                 key=lambda t: -t[1])[:5]
    named = {k: tuple(map(sum, zip((0.0, 0), *[
        v for name, v in by_name.items() if k in name]))) for k in kernels}
    return len(dev) - len(copies), len(copies), busy, wall, top, named


def profile_solve(solve, args):
    """One solve under torch.profiler (profile_device)."""
    return profile_device(lambda: solve(*args).cost.cpu())


def profile_text(prof, what):
    if prof is None:
        return "profile: no device events seen (not measured)"
    n_k, n_c, busy, wall, top, _ = prof
    return (f"profile of {what}: {n_k} kernel launches + {n_c} "
            f"copies/fills, device busy {busy:.2f} ms of {wall:.2f} ms "
            f"wall, idle share {1 - busy / wall:.3f}; most device time: "
            + "; ".join(f"{name} {ms:.2f} ms x{n}" for name, ms, n in top))


SOLVE_KW = dict(trim_output=True, parallel_line_search=False,
                fused_riccati=True, max_resets=MAX_RESETS, reg_floor=1e-3)
OPTS = SolverOptions(max_AL_iter=2, max_DDP_iter=1)


def fused_hooks():
    return dict(fused_forward=hf.make_hkd_fused_forward(),
                fused_lq=hf.make_hkd_fused_lq())


def phase_solve(label, tag, name, args, meta, hooks, want_kernels,
                opts=OPTS):
    """Timed solves of one configuration through the kernels: counts set
    to 0 just before and read just after; every kernel in want_kernels
    must have launched, and every scenario must succeed."""
    solve = make_batched_solver(hp.make_hkd_fns(), opts, **hooks, **SOLVE_KW)
    reset_counts()
    res, cost, success, ms = timed_solves(solve, args, N_TIMED)
    launches = read_counts()
    reset_counts()
    prof = profile_solve(solve, args)
    per_solve = read_counts()
    med = statistics.median(ms)
    n_ok = int(success.sum())
    prof_txt = profile_text(prof, "one solve")
    print(f"[{tag}] hkd {name} ({len(meta['phases'])} phases, "
          f"{meta['n_knots']} knots), B={B} f32: "
          f"{B / (med / 1e3):.1f} solves/s, median {med:.2f} ms per batched "
          f"solve (each: {', '.join(f'{m:.2f}' for m in ms)}); "
          f"success {n_ok}/{B}, cost finite "
          f"{bool(torch.isfinite(cost).all())}, iters "
          f"{res.info.iters[0].item()}, ls {res.info.ls_iters.sum().item()}, "
          f"reg {res.info.reg_iters.sum().item()}; kernel launches over "
          f"{N_TIMED + 1} solves {launches}, in the profiled solve "
          f"{per_solve}; "
          f"{prof_txt} [{label}]", flush=True)
    if n_ok != B or not bool(torch.isfinite(cost).all()):
        fail(f"the {name} solve did not succeed on every scenario")
    missed = [k for k in want_kernels
              if launches[k] == 0 or per_solve[k] == 0]
    if missed:
        fail(f"kernels of the {name} path were never launched: {missed}")
    return res, cost, success, med, per_solve


def phase_solves(label):
    """Phases 3, 3b and 4: the bench default through all four kernels, the
    configuration without the fused LQ and trial, and the bench default
    through the plain twins.  Returns the kernels' launches in phase 3's
    profiled solve, 3b's (result, cost, success) and 3's."""
    args, meta = bench_problem(torch.float32)
    res, cost, success, med, launches = phase_solve(
        label, "3", "bench default (fused LQ + trial)", args, meta,
        fused_hooks(), KERNELS)
    unfused = phase_solve(label, "3b", "without the fused LQ and trial",
                          args, meta, {}, ("sweep", "linroll"))[:3]

    solve_p = make_batched_solver(hp.make_hkd_fns(), OPTS, plain_ops=True,
                                  **fused_hooks(), **SOLVE_KW)
    reset_counts()
    res_p, cost_p, success_p, ms_p = timed_solves(solve_p, args, 2)
    if any(read_counts().values()):
        fail(f"the plain-twin solve launched kernels: {read_counts()}")
    med_p = statistics.median(ms_p)
    dX = float((res.Xbar - res_p.Xbar).abs().max())
    dU = float((res.Ubar - res_p.Ubar).abs().max())
    dc = float(((cost - cost_p) / cost_p).abs().max())
    print(f"[4] bench default, plain twins of all four kernels: "
          f"{B / (med_p / 1e3):.1f} solves/s (median {med_p:.2f} ms) vs "
          f"kernels {B / (med / 1e3):.1f} solves/s; success "
          f"{int(success_p.sum())}/{B}; kernel vs plain solve: max "
          f"|dXbar| {dX:.3e}, max |dUbar| {dU:.3e}, cost rel diff "
          f"{dc:.3e} (tol {COST_RTOL:g}) [{label}]", flush=True)
    if not (np.isfinite(dX) and np.isfinite(dU)):
        fail("kernel and plain solves are not finite")
    if not torch.equal(success, success_p) or not dc <= COST_RTOL:
        fail("the kernel solve disagrees with the plain-twin solve")
    return launches, unfused, (res, cost, success)


def phase_runtime(label, x0):
    """Phase 5: the MPC runtime at B=1 in f64, initialize + 5 updates, each
    fed the solver's own predicted state one MPC period ahead.  Returns
    each step's (state, command tape)."""
    qr = QuadReference(synthetic_bound_reference(duration=2.0))
    qr.initialize(PLAN_DURATION)
    cfg = hp.HKDConfig(plan_duration=PLAN_DURATION, n_steps_max=N_STEPS)
    rt = HKDMPCRuntime(qr, cfg, SolverOptions(), device=DEVICE,
                       dtype=torch.float64)
    x, lines, steps = x0, [], []
    for i in range(6):
        tape = rt.initialize(x) if i == 0 else rt.update(x)
        steps.append((x, tape))
        ok = bool(rt.result.success)
        lines.append(f"{'init' if i == 0 else f'update {i}'} "
                     f"{rt.last_solve_ms:.2f} ms success={ok}")
        if not ok or not np.isfinite(rt.result.cost):
            fail(f"runtime solve {i} failed")
        kn = rt.plan_np.knot
        j = int(np.where((np.abs(kn.t - rt.dt_mpc) < 1e-9)
                         & (kn.is_terminal == 0))[0][0])
        x = rt.result.Xbar[j]
    print("[5] runtime B=1 f64: " + "; ".join(lines) + f" [{label}]",
          flush=True)
    return steps


# Phase 6: the WB and SRB model layer at the `mhpc` config's production
# batch (the JAX package's bench.py:87-114 at its default B=256: 25 WB
# knots and 10 SRB tail knots per scenario), with 4 reset knots per
# scenario for the impulse partials
WB_KNOTS = B * 25
RESET_KNOTS = B * 4
SRB_KNOTS = B * 10
WB_DT, SRB_DT, BG_ALPHA = 0.01, 0.02, 10.0
N_CHECK = 64        # knots held to the CPU and to the per-knot wbm in f64
N_WB_TIMED = 5
F32_TOL = 1e-3      # f32 against f64 on the card, A and B, normalized
ROOT = os.path.dirname(os.path.abspath(__file__))


def wb_knot_data(n, seed):
    """n seeded WB knots (numpy f64): q around the stance pose
    [0, -0.8, 1.6] x 4 with the body's position and orientation spread
    (the JAX package's tests/test_wb_lane.py:16-27), v, u, random contact
    sets and dt."""
    rng = np.random.default_rng(seed)
    q = np.zeros((n, 18))
    q[:, 0:3] = rng.normal(0, 0.3, (n, 3))
    q[:, 2] += 0.25
    q[:, 3:6] = rng.normal(0, 0.4, (n, 3))
    q[:, 6:] = np.tile([0.0, -0.8, 1.6], 4) + rng.normal(0, 0.4, (n, 12))
    return dict(x=np.concatenate([q, rng.normal(0, 1.0, (n, 18))], 1),
                u=rng.normal(0, 5.0, (n, 12)), dt=np.full(n, WB_DT),
                c=(rng.random((n, 4)) > 0.4).astype(float))


def srb_knot_data(n, seed):
    """n seeded SRB knots (numpy f64): body state near standing height,
    ground forces, feet around the stance footprint, contact sets."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.3, (n, 12))
    x[:, 2] += 0.25
    feet = np.tile([0.19, 0.11, 0.0, 0.19, -0.11, 0.0, -0.19, 0.11, 0.0,
                    -0.19, -0.11, 0.0], (n, 1))
    return dict(x=x, u=rng.normal(0, 30.0, (n, 12)),
                pf=feet + rng.normal(0, 0.05, (n, 12)),
                c=(rng.random((n, 4)) > 0.4).astype(float))


def on(d, device, dtype, n=None):
    return {k: torch.tensor(a[:n], device=device, dtype=dtype)
            for k, a in d.items()}


def wb_partials(m, d):
    return wb_lane.wb_dyn_partials_lane(m, d["x"], d["u"], d["dt"], d["c"],
                                        BG_ALPHA)


def wb_step(m, d):
    return wb_lane.wb_dynamics_lane(m, d["x"], d["u"], d["dt"], d["c"],
                                    BG_ALPHA)


def impulse_partials(m, d):
    return wb_lane.impulse_dynamics_partials_lane(m, d["x"][:, :18],
                                                  d["x"][:, 18:], d["c"])


def srb_partials(d):
    return srb.dynamics_partials(d["x"], d["u"], d["pf"], d["c"], SRB_DT)


def rel_errors(got, want):
    """Max |got - want| / max |want| of each pair (want on any device)."""
    return [float((g.to(w.device, w.dtype) - w).abs().max()
                  / max(float(w.abs().max()), 1e-30))
            for g, w in zip(got, want)]


def median_event_ms(fn, n):
    """One warm-up call, then the median CUDA-event ms of n calls (each
    synchronized)."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return statistics.median(ms)


def kin_fixture_checks(m):
    """(foot_vel_dq, d(J^T F)/dq) of the synthetic robot on the card in f64
    against the reference's generated derivatives: max abs errors."""
    fix = np.load(os.path.join(ROOT, "tests", "fixtures",
                               "wb_kin_derivs.npz"))
    d = {k: torch.tensor(fix[k], device=DEVICE, dtype=torch.float64)
         for k in ("q", "v", "F")}
    dvdq = rbda.foot_vel_dq(m, d["q"], d["v"])
    Fl = d["F"].unflatten(-1, (4, 3))[..., None]
    djtf = rbda.batched_jacobian(
        lambda q_: (rbda.foot_jacobians(m, q_) * Fl).sum(-2), d["q"])
    return (float((dvdq.cpu() - torch.tensor(fix["dvdq"])).abs().max()),
            float((djtf.cpu() - torch.tensor(fix["dJTFdq"])).abs().max()))


def srb_fixture_check():
    """srb.dynamics_partials_continuous on the card in f64 against the
    reference's generated SRB derivatives: max abs error of Ac, Bc."""
    fix = np.load(os.path.join(ROOT, "tests", "fixtures",
                               "srb_dynamics.npz"))
    args = [torch.tensor(fix[k], device=DEVICE, dtype=torch.float64)
            for k in ("x", "u", "pf", "ctact")]
    Ac, Bc = srb.dynamics_partials_continuous(*args)
    return max(float((Ac.cpu() - torch.tensor(fix["Ac"])).abs().max()),
               float((Bc.cpu() - torch.tensor(fix["Bc"])).abs().max()))


def lane_models():
    """The synthetic quadruped's model on the card in f32 and f64 and on
    the CPU in f64, from a URDF written to a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        path = synthetic_robot.write_synthetic_quadruped_urdf(tmp)
        models = {dt: wb_lane.load_lane_model(path, DEVICE, dt)
                  for dt in (torch.float32, torch.float64)}
        models["cpu"] = wb_lane.load_lane_model(path, "cpu", torch.float64)
    return models


def phase_models(label):
    """Phase 6: the WB linearization on WB_KNOTS knots, the WB step, the
    impulse partials on RESET_KNOTS and the SRB partials on SRB_KNOTS, in
    f32 and f64 on the card; checks (a)-(e), then times and a profile."""
    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    models = lane_models()
    wb_np = wb_knot_data(WB_KNOTS, SEED + 6)
    imp_np = wb_knot_data(RESET_KNOTS, SEED + 7)
    srb_np = srb_knot_data(SRB_KNOTS, SEED + 8)
    wb = {dt: on(wb_np, DEVICE, dt) for dt in (f32, f64)}
    imp = {dt: on(imp_np, DEVICE, dt) for dt in (f32, f64)}
    srbd = {dt: on(srb_np, DEVICE, dt) for dt in (f32, f64)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    out = {dt: wb_partials(models[dt], wb[dt]) for dt in (f32, f64)}
    torch.cuda.synchronize()
    # (a) the card against the CPU, f64, on the first N_CHECK knots
    cpu = models["cpu"]
    wb_c, imp_c, srb_c = (on(d, "cpu", f64, N_CHECK)
                          for d in (wb_np, imp_np, srb_np))
    wb_g, imp_g, srb_g = (on(d, DEVICE, f64, N_CHECK)
                          for d in (wb_np, imp_np, srb_np))
    err_a = {
        "ABCD": rel_errors([o[:N_CHECK] for o in out[f64]],
                           wb_partials(cpu, wb_c)),
        "step": rel_errors(wb_step(models[f64], wb_g), wb_step(cpu, wb_c)),
        "impulse": rel_errors(impulse_partials(models[f64], imp_g),
                              impulse_partials(cpu, imp_c)),
        "srb": rel_errors(srb_partials(srb_g), srb_partials(srb_c))}
    worst_a = max(max(v) for v in err_a.values())
    # (b) the lane form against the per-knot wbm on the card, f64
    per_knot = wbm.dynamics_partials_analytic(
        models[f64], wb_g["x"], wb_g["u"], WB_DT, wb_g["c"], BG_ALPHA)
    err_b = [float((o[:N_CHECK] - w).abs().max())
             for o, w in zip(out[f64], per_knot)]
    ok_b = all(e <= tol for e, tol in zip(err_b, (1e-8, 1e-8, 1e-6, 1e-6)))
    # (c), (d) the reference's fixtures on the card, f64
    err_c = kin_fixture_checks(models[f64])
    err_d = srb_fixture_check()
    # (e) f32 against f64 on the card, all knots
    finite = all(bool(torch.isfinite(o).all()) for o in out[f32])
    err_e = rel_errors(out[f32], out[f64])
    print(f"[6] checks, WB model layer on the synthetic quadruped "
          f"(synthetic inertias): (a) card vs CPU f64 on {N_CHECK} knots, "
          f"normalized: A,B,C,D "
          + ", ".join(f"{e:.3e}" for e in err_a["ABCD"])
          + "; step " + ", ".join(f"{e:.3e}" for e in err_a["step"])
          + "; impulse " + ", ".join(f"{e:.3e}" for e in err_a["impulse"])
          + "; srb " + ", ".join(f"{e:.3e}" for e in err_a["srb"])
          + " (tol 1e-10); (b) lane vs per-knot wbm f64, max abs: "
          + ", ".join(f"{e:.3e}" for e in err_b)
          + " (tol 1e-8, 1e-8, 1e-6, 1e-6); (c) wb_kin_derivs: dvdq "
          f"{err_c[0]:.3e}, dJTFdq {err_c[1]:.3e} (tol 1e-10); (d) "
          f"srb_dynamics Ac/Bc {err_d:.3e} (tol 1e-10); (e) f32 vs f64 on "
          f"{WB_KNOTS} knots, normalized: A {err_e[0]:.3e}, B "
          f"{err_e[1]:.3e}, C {err_e[2]:.3e}, D {err_e[3]:.3e}, f32 finite "
          f"{finite} (A, B tol {F32_TOL:g}) [{label}]", flush=True)
    if not worst_a <= 1e-10:
        fail(f"the card's f64 model layer disagrees with the CPU's: "
             f"{worst_a:.3e}")
    if not ok_b:
        fail(f"the lane WB partials disagree with the per-knot wbm: {err_b}")
    if not max(err_c) < 1e-10 or not err_d < 1e-10:
        fail(f"the model layer misses the reference's fixtures: {err_c}, "
             f"{err_d:.3e}")
    if not (finite and max(err_e[:2]) <= F32_TOL):
        fail(f"the f32 WB partials are not finite or too far from f64: "
             f"{err_e}")

    ms = {}
    for dt in (f32, f64):
        n = str(dt)[6:]
        ms[f"wb_{n}"] = median_event_ms(
            lambda: wb_partials(models[dt], wb[dt]), N_WB_TIMED)
        ms[f"impulse_{n}"] = median_event_ms(
            lambda: impulse_partials(models[dt], imp[dt]), N_WB_TIMED)
        ms[f"srb_{n}"] = median_event_ms(lambda: srb_partials(srbd[dt]),
                                         N_WB_TIMED)
    prof = {dt: profile_device(lambda: wb_partials(models[dt], wb[dt]),
                               host=False)
            for dt in (f32, f64)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[6] WB/SRB model layer at the mhpc batch (B={B}): "
          f"wb_dyn_partials_lane on {WB_KNOTS} knots, median CUDA-event ms "
          f"per call over {N_WB_TIMED} calls: f32 {ms['wb_float32']:.2f} "
          f"({WB_KNOTS / ms['wb_float32'] * 1e3:.0f} knots/s), f64 "
          f"{ms['wb_float64']:.2f} ({WB_KNOTS / ms['wb_float64'] * 1e3:.0f} "
          f"knots/s); impulse_dynamics_partials_lane on {RESET_KNOTS} "
          f"knots f32 {ms['impulse_float32']:.2f}, f64 "
          f"{ms['impulse_float64']:.2f} ms; srb.dynamics_partials on "
          f"{SRB_KNOTS} knots f32 {ms['srb_float32']:.2f}, f64 "
          f"{ms['srb_float64']:.2f} ms; f32 "
          + profile_text(prof[f32], "one WB call") + "; f64 "
          + profile_text(prof[f64], "one WB call")
          + f"; peak device memory over the phase "
          f"{peak:.2f} GiB; phase {time.perf_counter() - t_phase:.1f} s "
          f"[{label}]", flush=True)


# Phase 7: the MHPC cascade, the JAX package's bench.py:87-147
# configurations (whole-body head, SRB tail; xs=36, us=ys=12) with the
# in-code default settings, on the synthetic quadruped and the urdf-order
# synthetic bound reference
MHPC_B = 256
CASCADE_B = 128
N_MHPC_TIMED = 2
N_RT_UPDATES = 3
MHPC_OPTS = SolverOptions(max_AL_iter=4, max_DDP_iter=1)
MHPC_KW = dict(trim_output=True, parallel_line_search=False,
               fused_riccati=True, reg_floor=1e-3)
PATH_KERNELS = ("sweep", "linroll")


def mhpc_cfg(qr):
    """The `mhpc` config (bench.py:87-110): WB 0.25 s at 0.01, SRB 0.5 s at
    0.05, n_steps_max 48, wb_block 32."""
    return mp.MHPCConfig()


def cascade500_cfg(qr):
    """The `cascade500` config (bench.py:113-147): WB 2.5 s at 0.01, SRB
    5.0 s at 0.02, wb_block and n_steps_max sized from the discovered WB
    phases."""
    cfg = mp.MHPCConfig(plan_dur_wb=2.5, dt_wb=0.01, plan_dur_srb=5.0,
                        dt_srb=0.02)
    phases = mp.discover_wb_phases(qr, cfg.plan_dur_wb, cfg.dt_wb)
    cfg.wb_block = sum(p[2] for p in phases) + len(phases)
    cfg.n_steps_max = cfg.wb_block + round(cfg.plan_dur_srb / cfg.dt_srb)
    return cfg


def mhpc_problem(Bsz, dtype, make_cfg, window, duration):
    """(cfg, solver inputs, plan metadata) of one MHPC configuration on the
    card: the reference window `window` s of a synthetic bound `duration`
    s long; x0 = the WB state reference at t=0 + N(0, 0.01), seed 0
    (bench.py:211-213)."""
    qr = QuadReference(synthetic_bound_reference_urdf(duration=duration))
    qr.initialize(window)
    cfg = make_cfg(qr)
    plan_np, pen_np, Xbar0, Ubar0, meta = mp.build_mhpc_plan(qr, cfg)
    x0 = wb_state_ref_at(qr, 0.0).astype(np.float32)[None] \
        + np.random.default_rng(SEED).normal(0, 0.01, (Bsz, mp.XS))
    plan, pen, x0, Xbar0, Ubar0 = convert.from_numpy(
        (plan_np, pen_np, x0, Xbar0, Ubar0), DEVICE, dtype)
    return cfg, (plan, broadcast_batch(pen, Bsz), x0,
                 broadcast_batch(Xbar0, Bsz),
                 broadcast_batch(Ubar0, Bsz)), meta


def mhpc_models():
    """The synthetic quadruped's whole-body model on the card in f32 and
    f64, from a URDF written to a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        path = synthetic_robot.write_synthetic_quadruped_urdf(tmp)
        return {dt: wbm.load_model(path, DEVICE, dt)
                for dt in (torch.float32, torch.float64)}


def capturing_solver(fns, opts=MHPC_OPTS, **kw):
    """make_batched_solver(fns, opts, **kw) whose sweep and linroll calls
    also keep a copy of their first call's operands: the kernels' inputs
    at the solve's own shapes and values."""
    seen, real = {}, {"sweep": sweep_mod.sweep, "linroll": linroll_mod.linroll}

    def keep(name):
        def call(*a):
            seen.setdefault(name, tuple(
                t.clone() if torch.is_tensor(t) else t for t in a))
            return real[name](*a)
        return call
    sweep_mod.sweep, linroll_mod.linroll = keep("sweep"), keep("linroll")
    try:
        return make_batched_solver(fns, opts, **kw), seen
    finally:
        sweep_mod.sweep, linroll_mod.linroll = real["sweep"], real["linroll"]


def path_kernel_figures(seen, label, tag="7a", what="mhpc",
                        dtypes=(torch.float32, torch.float64)):
    """The sweep and linroll kernels on a solve's captured operands, in
    each of `dtypes`: against their twins (ok flags equal; f64 to 1e-10);
    in the first of them, device ms per launch by the profiler, twin ms
    and bound."""
    out = {}
    ins = seen["sweep"]
    for dtype in dtypes:
        a = tuple(t.to(dtype) if torch.is_tensor(t) and t.is_floating_point()
                  else t for t in ins)
        got, want = sweep_mod.sweep(*a), sweep_mod.sweep_reference(*a)
        ok_k, ok_r = got[7] > 0.5, want[7] > 0.5
        if not torch.equal(ok_k, ok_r):
            fail(f"sweep ok flags differ on the {what} operands ({dtype}): "
                 f"kernel {int(ok_k.sum())}, twin {int(ok_r.sum())} ok")
        if not bool(ok_k.any()):
            fail(f"no scenario's sweep is ok on the {what} operands "
                 f"({dtype})")
        errs = {n: errors(got[i], want[i], ok_k)
                for i, n in ((0, "G"), (1, "H"), (2, "K"), (3, "dU"),
                             (8, "dv"))}
        M = a[0] + a[1] @ got[2]
        c = seen["linroll"][1].to(dtype)
        dx0 = seen["linroll"][2].to(dtype)
        lr_args = (M.contiguous(), c, dx0)
        dX = linroll_mod.linroll(*lr_args)
        errs["dX"] = errors(dX, linroll_mod.linroll_reference(*lr_args),
                            ok_k)
        worst = max(e[1] for e in errs.values())
        n = str(dtype)[6:]
        print(f"[{tag}] sweep + linroll kernels vs twins on the {what} "
              f"solve's first sweep operands (B={ok_k.numel()}, "
              f"N={a[2].shape[1]}, "
              f"xs={a[2].shape[2]}, us={a[3].shape[2]}, {n}): ok "
              f"{int(ok_k.sum())} in both; max err (abs, normalized) "
              + " ".join(f"{k}=({e[0]:.3e}, {e[1]:.3e})"
                         for k, e in errs.items()) + f" [{label}]",
              flush=True)
        if dtype == torch.float64 and not worst <= 1e-10:
            fail(f"the f64 sweep or linroll disagrees with its twin on the "
                 f"{what} operands: {worst:.3e}")
        if dtype == dtypes[0]:
            peak = PEAK_F64 if dtype == torch.float64 else PEAK_F32
            out["sweep_err"] = max(errs[k][0] for k in ("G", "H", "K", "dU",
                                                        "dv"))
            out["linroll_err"] = errs["dX"][0]
            out["sweep_bound"] = bound(nbytes(a, got), sweep_flops(a), peak)
            out["sweep_ms"] = kernel_ms(lambda: sweep_mod.sweep(*a), 20,
                                        "sweep_kernel")
            out["sweep_plain_ms"] = time_ms(
                lambda: sweep_mod.sweep_reference(*a), 2)
            out["linroll_bound"] = bound(nbytes(lr_args, (dX,)),
                                         2.0 * M.numel() + c.numel(), peak)
            out["linroll_ms"] = kernel_ms(
                lambda: linroll_mod.linroll(*lr_args), 50, "linroll_kernel")
            out["linroll_plain_ms"] = time_ms(
                lambda: linroll_mod.linroll_reference(*lr_args), 5)
    return out


def solve_text(res, cost, success):
    info = res.info
    return (f"success {int(success.sum())}/{success.numel()}, cost finite "
            f"{bool(torch.isfinite(cost).all())}, iters "
            f"{info.iters.max().item()}, ls {info.ls_iters.sum().item()}, "
            f"reg {info.reg_iters.sum().item()}")


def f64_rerun(cfg, model, bad, label):
    """The f32 solve's failing scenarios `bad` solved again in f64 on the
    card: fails the script where any of them succeeds in f64."""
    _, args, _ = mhpc_problem(MHPC_B, torch.float64, mhpc_cfg, 0.75, 2.0)
    plan, *rest = args
    idx = bad.nonzero().flatten().to(DEVICE)
    rest = [type(t)(*[a[idx] for a in t]) if isinstance(t, tuple) else t[idx]
            for t in rest]
    solve = make_batched_solver(mp.make_mhpc_fns_segmented(cfg, model),
                                MHPC_OPTS, max_resets=MAX_RESETS, **MHPC_KW)
    res = solve(plan, *rest)
    ok64 = res.success.cpu() & torch.isfinite(res.cost.cpu())
    print(f"[7a] the {int(bad.sum())} scenarios that fail in f32 ("
          f"{bad.nonzero().flatten().tolist()}), solved in f64: success "
          f"{ok64.tolist()} [{label}]", flush=True)
    if bool(ok64.any()):
        fail("an mhpc scenario fails in f32 but succeeds in f64")


def phase_mhpc(label, models):
    """Phase 7a: the `mhpc` bench configuration at B=256, f32, through the
    sweep and linroll kernels; then the same solve through their twins."""
    f32 = torch.float32
    cfg, args, meta = mhpc_problem(MHPC_B, f32, mhpc_cfg, 0.75, 2.0)
    fns = mp.make_mhpc_fns_segmented(cfg, models[f32])
    kw = dict(MHPC_KW, max_resets=MAX_RESETS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solve_c, seen = capturing_solver(fns, **kw)
    solve_c(*args).cost.cpu()      # the warm-up, keeping kernel operands
    warm_s = time.perf_counter() - t0
    solve = make_batched_solver(fns, MHPC_OPTS, **kw)
    reset_counts()
    res, cost, success, ms = timed_solves(solve, args, N_MHPC_TIMED,
                                          warmup=False)
    launches = read_counts()
    reset_counts()
    prof = profile_device(lambda: solve(*args).cost.cpu(), host=False,
                          kernels=("sweep_kernel", "linroll_kernel"))
    per_solve = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(ms)
    st = args[0].step
    print(f"[7a] mhpc ({len(meta['wb_phases'])} WB phases, "
          f"{meta['n_knots']} knots, {int(st.is_reset.sum())} resets, "
          f"xs={mp.XS}), B={MHPC_B} f32, {MHPC_OPTS.max_AL_iter} AL x "
          f"{MHPC_OPTS.max_DDP_iter} DDP: {MHPC_B / (med / 1e3):.2f} solves/s,"
          f" median {med:.1f} ms per batched solve (each: "
          f"{', '.join(f'{m:.1f}' for m in ms)}; warm-up {warm_s:.1f} s); "
          f"{solve_text(res, cost, success)}; kernel launches over "
          f"{N_MHPC_TIMED} solves {launches}, in the profiled solve "
          f"{per_solve}; {profile_text(prof, 'one solve (device only)')}; "
          f"path kernels in it: "
          + (", ".join(f"{k} {t:.3f} ms x{n}" for k, (t, n) in prof[5].items())
             if prof else "not measured")
          + f"; peak device memory {peak:.2f} GiB [{label}]", flush=True)
    missed = [k for k in PATH_KERNELS if launches[k] == 0 or per_solve[k] == 0]
    if missed:
        fail(f"kernels of the mhpc path were never launched: {missed}")
    bad = ~(success & torch.isfinite(cost))
    if bool(bad.any()):
        f64_rerun(cfg, models[torch.float64], bad, label)

    solve_p = make_batched_solver(fns, MHPC_OPTS, plain_ops=True, **kw)
    reset_counts()
    res_p, cost_p, success_p, ms_p = timed_solves(solve_p, args, 1,
                                                  warmup=False)
    if any(read_counts().values()):
        fail(f"the plain-twin mhpc solve launched kernels: {read_counts()}")
    both = torch.isfinite(cost) & torch.isfinite(cost_p)
    dX = float((res.Xbar - res_p.Xbar)[both.to(DEVICE)].abs().max())
    dU = float((res.Ubar - res_p.Ubar)[both.to(DEVICE)].abs().max())
    dc = float(((cost - cost_p) / cost_p)[both].abs().max())
    same_it = all(torch.equal(getattr(res.info, f), getattr(res_p.info, f))
                  for f in ("iters", "ls_iters", "reg_iters"))
    print(f"[7a] mhpc through the plain twins: {ms_p[0]:.1f} ms per solve; "
          f"{solve_text(res_p, cost_p, success_p)}; kernel vs plain solve: "
          f"success flags equal {torch.equal(success, success_p)}, "
          f"iteration counts equal per scenario {same_it}, max |dXbar| "
          f"{dX:.3e}, max |dUbar| {dU:.3e}, cost rel diff {dc:.3e} (tol "
          f"{COST_RTOL:g}) [{label}]", flush=True)
    if not torch.equal(success, success_p) or not dc <= COST_RTOL:
        fail("the mhpc kernel solve disagrees with its plain-twin solve")
    figs = path_kernel_figures(seen, label)
    figs["launches"] = per_solve
    figs["solve"] = (cost, success)
    figs["info"] = res.info
    return figs


def phase_mhpc_runtime(label, model):
    """Phase 7b: MHPCRuntime at B=1 in f64, initialize + N_RT_UPDATES
    updates, each fed the solver's own predicted state one MPC period
    ahead; the ms of each step split into host plan build, solve and
    fetch.  Returns each step's (state, command tape)."""
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(0.75)
    rt = MHPCRuntime(qr, mp.MHPCConfig(), SolverOptions(), model=model,
                     device=DEVICE, dtype=torch.float64)
    x, lines, steps = wb_state_ref_at(qr, 0.0), [], []
    for i in range(N_RT_UPDATES + 1):
        tape = rt.initialize(x) if i == 0 else rt.update(x)
        steps.append((x, tape))
        r, t = rt.result, rt.timing
        ok = bool(r["success"]) and np.isfinite(r["cost"])
        lines.append(f"{'init' if i == 0 else f'update {i}'} build "
                     f"{t['build_ms']:.1f} + solve {t['solve_ms']:.1f} + "
                     f"fetch {t['fetch_ms']:.1f} ms, iters "
                     f"{int(r['info'].iters)}, success {ok}")
        if not ok or tape.torque.shape != (rt.n_cmd_steps, 12) \
                or not np.isfinite(tape.Quu).all():
            fail(f"mhpc runtime step {i} failed or gave a bad command tape")
        kn = rt.plan_np.knot
        j = int(np.where((np.abs(kn.t - rt.cfg.dt_mpc) < 1e-9)
                         & (kn.is_terminal == 0))[0][0])
        x = r["Xbar"][j]
    print(f"[7b] MHPC runtime B=1 f64 against the {rt.cfg.dt_mpc * 1e3:.0f} "
          "ms MPC period: " + "; ".join(lines) + f" [{label}]", flush=True)
    return steps


def phase_cascade500(label, model):
    """Phase 7c: one solve of the `cascade500` configuration at B=128,
    f32, after one warm-up."""
    cfg, args, meta = mhpc_problem(CASCADE_B, torch.float32, cascade500_cfg,
                                   7.6, 8.0)
    solve = make_batched_solver(mp.make_mhpc_fns_segmented(cfg, model),
                                MHPC_OPTS, max_resets=32, **MHPC_KW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, cost, success, ms = timed_solves(solve, args, 1)
    n_reset = int(args[0].step.is_reset.sum())
    print(f"[7c] cascade500 ({len(meta['wb_phases'])} WB phases, "
          f"{meta['n_knots']} knots: {meta['n_knots'] - 1 - n_reset} "
          f"dynamics steps, {n_reset} resets), B={CASCADE_B} "
          f"f32: {ms[0]:.1f} ms per batched solve "
          f"({CASCADE_B / (ms[0] / 1e3):.2f} solves/s; warm-up and solve "
          f"{time.perf_counter() - t0:.1f} s); "
          f"{solve_text(res, cost, success)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{label}]",
          flush=True)
    if not bool(torch.isfinite(cost[success]).all()):
        fail("a cascade500 scenario succeeded with a non-finite cost")


# Phase 8: the serving path, sim <-> MPC <-> C++ consumer over LCM UDP
# multicast on the machine's loopback (ttl 0): the MPC server runs in this
# process on the card, the sim role of the port's two-process examples and
# the C++ listener of native/ as subprocesses
N_SERVED = 20           # 8b: MPC steps of the HKD closed loop
N_LISTENED = 10         # commands the C++ consumer must decode
N_QUEUED = 5            # 8c: states queued before one serve()
N_MHPC_SERVED = 4       # 8d: init + 3 updates
SERVE_DEADLINE_S = 300  # longest a served loop may take
FRAGMENTED_SZ = 200     # rows of the wbTraj_lcmt sent in LC03 fragments


def wire_messages():
    """One message of each of the eleven types with fields from the seed
    (variable dimensions 3), and a wbTraj_lcmt of FRAGMENTED_SZ rows."""
    rng = np.random.default_rng(SEED)

    def filled(cls, n):
        msg = cls()
        for f in cls.FIELDS:
            if not f.dims:
                setattr(msg, f.name, n if f.typ.startswith("int")
                        else float(rng.normal()) if f.typ != "boolean"
                        else True)
        for f in cls.FIELDS:
            if f.dims:
                shape = msg._shape(f)
                setattr(msg, f.name, rng.integers(-9, 9, shape)
                        if f.typ.startswith("int") or f.typ == "boolean"
                        else rng.normal(size=shape))
        return msg

    return ([(cls.__name__, filled(cls, 3)) for cls in wire.ALL_TYPES]
            + [("wbTraj_lcmt (fragmented)",
                filled(wire.wbTraj_lcmt, FRAGMENTED_SZ))])


def roundtrip(tx, rx, channel, data):
    """Publish `data` on tx and wait up to 5 s for rx to deliver it."""
    got = []
    rx.subscribe(channel, lambda _c, d: got.append(d))
    tx.publish(channel, data)
    t_end = time.monotonic() + 5.0
    while not got and time.monotonic() < t_end:
        rx.handle(0.05)
    if not got:
        fail(f"{channel}: nothing received within 5 s")
    return got[0]


def phase_wire(label):
    """8a: every message type through the Python and the native transport
    in both directions, bytes and decoded fields compared."""
    t0 = time.perf_counter()
    py, nat = UDPMulticast(), native.NativeUDPMulticast()
    sizes = []
    try:
        for name, msg in wire_messages():
            data = msg.encode()
            for way, tx, rx in (("py-native", py, nat),
                                ("native-py", nat, py)):
                back = roundtrip(tx, rx, f"smoke_{way}_{name.split()[0]}"
                                 f"_{len(data)}", data)
                dec = type(msg).decode(back)
                if back != data or dec.encode() != data:
                    fail(f"{name} {way}: received bytes differ")
            sizes.append(f"{name} {len(data)} B / "
                         f"{len(frame(0, 'x', data))} datagram(s)")
    finally:
        py.close()
        nat.close()
    print(f"[8a] wire: {len(sizes)} messages, each Python -> native and "
          "native -> Python over UDP multicast "
          f"{DEFAULT_ADDR[0]}:{DEFAULT_ADDR[1]}"
          f" ttl 0, byte-identical: " + "; ".join(sizes)
          + f"; {time.perf_counter() - t0:.2f} s [{label}]", flush=True)


def start(args, what):
    """A child process of this script (the port on its path), stdout and
    stderr piped."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    proc = subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.what = what
    return proc


def sim_args(module, steps):
    return [sys.executable, "-m", module.MODULE, "--role", "sim", "--steps",
            str(steps), "--device", "cpu", "--republish-s", "0"]


class Watchdog:
    """Ends the script (exit 1, no result) when a child exits non-zero or
    SERVE_DEADLINE_S passes while this process waits in serve(): a served
    loop whose sim died would wait for its next state for ever."""

    def __init__(self, what, procs):
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._watch, args=(what, procs),
                                       daemon=True)
        self.thread.start()

    def _watch(self, what, procs):
        t_end = time.monotonic() + SERVE_DEADLINE_S
        while not self.done.wait(0.5):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if not bad and time.monotonic() < t_end:
                continue
            for p in procs:
                p.kill()
            tails = []
            for p in procs:
                out, err = p.communicate(timeout=10)
                tails.append(f"{p.what} rc {p.returncode}: "
                             f"{(out + err)[-1500:]}")
            print(f"chip_smoke FAILED: {what}: "
                  + ("a child failed" if bad else
                     f"not done in {SERVE_DEADLINE_S} s") + "\n"
                  + "\n".join(tails), file=sys.stderr, flush=True)
            os._exit(1)

    def stop(self):
        self.done.set()
        self.thread.join()


def finish(proc, timeout=60):
    """Wait for a child; fails unless it exits 0.  Returns its stdout."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        fail(f"{proc.what} did not exit within {timeout} s: {err[-1500:]}")
    if proc.returncode != 0:
        fail(f"{proc.what} exited {proc.returncode}: {(out + err)[-1500:]}")
    return out


def sim_steps(out, n):
    """The sim's per-step figures from its `{"sim": ...}` line."""
    lines = [l for l in out.splitlines() if l.startswith('{"sim"')]
    if not lines:
        fail("the sim printed no figures")
    steps = json.loads(lines[-1])["sim"]["steps"]
    if len(steps) != n:
        fail(f"the sim got {len(steps)} commands, not {n}")
    return steps


def dedup(buf):
    """Subscriber keeping only messages that differ from the last one kept
    (multicast loopback can deliver a datagram once per interface)."""
    def cb(_c, m):
        if not buf or buf[-1].encode() != m.encode():
            buf.append(m)
    return cb


def pump(ep, seconds=0.2):
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end:
        ep.handle(0.02)


def serve_steps(rt, ep, n):
    """n calls of rt.serve(ep, max_msgs=1): each must run one solve that
    launches the sweep and the linroll kernels (counts set to 0 just
    before, read just after).  Returns per call (timing, launches).
    Clients are read only afterwards: their sockets hold what arrives, and
    the server is not held up between calls."""
    solves = []
    real_solve = rt._solve
    rt._solve = lambda *a: solves.append(1) or real_solve(*a)
    out = []
    for i in range(n):
        n_solves = len(solves)
        reset_counts()
        if rt.serve(ep, max_msgs=1) != 1 or len(solves) != n_solves + 1:
            fail(f"served call {i} did not run exactly one solve")
        launches = read_counts()
        if not all(launches[k] > 0 for k in PATH_KERNELS):
            fail(f"served solve {i} launched {launches}")
        out.append((dict(rt.timing), launches))
    return out


def med_max(vals):
    return f"median {statistics.median(vals):.2f}, max {max(vals):.2f}"


def serve_text(steps, served, period_ms):
    lat = [s["latency_ms"] for s in steps]
    parts = {k: [t[k] for t, _ in served]
             for k in ("build_ms", "solve_ms", "fetch_ms")}
    lines = [f"{i}: latency {s['latency_ms']:.2f} ms = build "
             f"{t['build_ms']:.2f} + solve {t['solve_ms']:.2f} + fetch "
             f"{t['fetch_ms']:.2f} ms + wire/host, sweep x{c['sweep']} "
             f"linroll x{c['linroll']}"
             for i, (s, (t, c)) in enumerate(zip(steps, served))]
    return ("; ".join(lines) + f"; latency ms {med_max(lat)}; build ms "
            f"{med_max(parts['build_ms'])}; solve ms "
            f"{med_max(parts['solve_ms'])}; fetch ms "
            f"{med_max(parts['fetch_ms'])}; against the {period_ms:.0f} ms "
            "period")


def same_message(got, want, what):
    """got (decoded off the wire) equals want after the schema's f32 cast,
    field by field and byte for byte."""
    want = wire.f32_cast(want)
    for f in type(want).FIELDS:
        if not np.array_equal(np.asarray(getattr(got, f.name)),
                              np.asarray(getattr(want, f.name))):
            fail(f"{what}: field {f.name} differs from the runtime's")
    if got.encode() != want.encode():
        fail(f"{what}: bytes differ from the runtime's")


def phase_serve_hkd(label):
    """8b: HKDMPCRuntime at phase 5's configuration serving the HKD sim
    role for N_SERVED MPC steps, the C++ listener decoding the commands;
    8c: N_QUEUED states queued before one serve(max_msgs=1)."""
    qr = QuadReference(synthetic_bound_reference(duration=ex_hkd.REF_DURATION))
    qr.initialize(PLAN_DURATION)
    cfg = hp.HKDConfig(plan_duration=PLAN_DURATION, n_steps_max=N_STEPS)
    if (cfg.dt_sim, cfg.nsteps_between_mpc) != (ex_hkd.DT_SIM,
                                                ex_hkd.NSTEPS_MPC):
        fail("the sim's dt_sim or steps per period are not the runtime's")
    rt = HKDMPCRuntime(qr, cfg, SolverOptions(), device=DEVICE,
                       dtype=torch.float64)
    ep = LCMEndpoint(UDPMulticast())
    client = LCMEndpoint(UDPMulticast())
    cmds = []
    client.subscribe("mpc_command", wire.hkd_command_lcmt, dedup(cmds))
    listener = start([str(native.build_listener()), str(N_LISTENED)],
                     "the C++ listener")
    first = listener.stdout.readline()
    if "waiting on mpc_command" not in first:
        fail(f"the C++ listener did not start: {first!r}")
    sim = start(sim_args(ex_hkd, N_SERVED), "the HKD sim")
    dog = Watchdog("8b HKD served loop", [sim, listener])
    served = serve_steps(rt, ep, N_SERVED)
    dog.stop()
    steps = sim_steps(finish(sim), N_SERVED)
    heard = first + finish(listener)
    n_heard = [int(l.split("ok:")[1].split()[0]) for l in heard.splitlines()
               if "ok:" in l]
    if not n_heard or n_heard[0] < N_LISTENED:
        fail(f"the C++ listener decoded no {N_LISTENED} commands: {heard}")
    pump(client, 0.5)
    last = [c for c in cmds if c.mpc_times[0] == rt.mpc_time]
    if not last:
        fail("the client saw no command of the last served state")
    same_message(last[-1], rt.command_message(solve_time=last[-1].solve_time),
                 "8b hkd_command_lcmt")
    print(f"[8b] HKD served closed loop, HKDMPCRuntime B=1 f64 "
          f"({N_STEPS} steps, {PLAN_DURATION} s plan) <- sim subprocess "
          f"(HKD dynamics, dt_sim {cfg.dt_sim}, {cfg.nsteps_between_mpc} "
          f"steps a period), {N_SERVED} MPC steps, sim z "
          f"{min(s['z'] for s in steps):.3f}..{max(s['z'] for s in steps):.3f}"
          f" m; C++ listener: {n_heard[0]} commands decoded; last command "
          f"equal to the runtime's after the f32 cast; per step "
          + serve_text(steps, served, rt.dt_mpc * 1e3) + f" [{label}]",
          flush=True)
    ep.close()

    # 8c: a fresh socket, so that only the queued states are pending
    ep = LCMEndpoint(UDPMulticast())
    kn = rt.plan_np.knot
    x = rt.result.Xbar[int(np.where((np.abs(kn.t - rt.dt_mpc) < 1e-9)
                                    & (kn.is_terminal == 0))[0][0])]
    t_last = rt.mpc_time
    for k in range(1, N_QUEUED + 1):
        client.publish("mpc_data", wire.hkd_data_lcmt(
            reset_mpc=False, MS=True, mpctime=t_last + k * rt.dt_mpc,
            contact=np.ones(4, np.int32), rpy=x[0:3][::-1], p=x[3:6],
            omegaBody=x[6:9], vWorld=x[9:12], qJ=[0.0, -0.8, 1.6] * 4,
            foot_placements=x[12:24]))
    time.sleep(0.1)
    (t, launches), = serve_steps(rt, ep, 1)
    pump(client, 0.5)
    want_t = t_last + N_QUEUED * rt.dt_mpc
    got = [c for c in cmds if abs(c.mpc_times[0] - want_t) < 1e-9]
    if abs(rt.mpc_time - want_t) > 1e-9 or not got:
        fail(f"8c: the solve was not on the newest state (mpc_time "
             f"{rt.mpc_time}, want {want_t})")
    print(f"[8c] {N_QUEUED} states queued (mpctime {t_last + rt.dt_mpc:.2f}"
          f"..{want_t:.2f}) then serve(max_msgs=1): 1 solve, on the newest "
          f"(command mpc_times[0] {got[-1].mpc_times[0]:.2f}), build "
          f"{t['build_ms']:.2f} + solve {t['solve_ms']:.2f} "
          f"+ fetch {t['fetch_ms']:.2f} ms, launches {launches} [{label}]",
          flush=True)
    ep.close()
    client.close()


def phase_serve_mhpc(label, model):
    """8d: MHPCRuntime at phase 7b's configuration with debug_intermtraj
    serving the MHPC sim role for init + 3 updates; a client endpoint
    counts the telemetry and checks the commands."""
    cfg = mp.MHPCConfig()
    if (cfg.dt_wb, cfg.dt_mpc) != (ex_mhpc.DT_WB, ex_mhpc.DT_MPC):
        fail("the MHPC sim's dt or period are not the runtime's")
    qr = QuadReference(synthetic_bound_reference_urdf(
        duration=ex_mhpc.REF_DURATION))
    qr.initialize(0.75)
    rt = MHPCRuntime(qr, cfg, SolverOptions(), model=model, device=DEVICE,
                     dtype=torch.float64, debug_intermtraj=True)
    ep = LCMEndpoint(UDPMulticast())
    n_pub = []      # intermediate trajectories this process published
    publish = ep.publish

    def counting(channel, msg):
        if channel == "intermediate_ddp_traj":
            n_pub.append(msg)
        publish(channel, msg)
    ep.publish = counting
    client = LCMEndpoint(UDPMulticast())
    cmds, info, interm = [], [], []
    client.subscribe("MHPC_COMMAND", wire.MHPC_Command_lcmt, dedup(cmds))
    client.subscribe("DDP_Solver_Info", wire.solver_info_lcmt, dedup(info))
    client.subscribe("intermediate_ddp_traj", wire.solver_intermtraj_lcmt,
                     dedup(interm))
    sim = start(sim_args(ex_mhpc, N_MHPC_SERVED), "the MHPC sim")
    dog = Watchdog("8d MHPC served loop", [sim])
    served, al_iters = [], []
    for i in range(N_MHPC_SERVED):
        before = len(n_pub)
        served += serve_steps(rt, ep, 1)
        al_iters.append(len(n_pub) - before)
    dog.stop()
    steps = sim_steps(finish(sim), N_MHPC_SERVED)
    pump(client, 1.0)
    iters = int(rt.result["info"].iters)
    if len(info) != N_MHPC_SERVED or len(cmds) < N_MHPC_SERVED:
        fail(f"8d: {len(info)} solver_info and {len(cmds)} commands "
             f"received for {N_MHPC_SERVED} solves")
    kept = []       # the published ones, deduplicated as the client does
    for m in n_pub:
        dedup(kept)(None, m)
    if len(interm) != len(kept) or al_iters[-1] != iters:
        fail(f"8d: {len(interm)} intermediate trajectories received, "
             f"{al_iters} published per solve, last solve {iters} AL x 1 DDP")
    cmd = cmds[-1]
    if not all(np.isfinite(np.asarray(getattr(cmd, f.name), float)).all()
               for f in cmd.FIELDS):
        fail("8d: the last MHPC command is not finite")
    same_message(cmd, rt.command_message(), "8d MHPC_Command_lcmt")
    n_bytes = len(cmd.encode())
    print(f"[8d] MHPC served loop, MHPCRuntime B=1 f64 (mhpc config, "
          f"debug_intermtraj) <- sim subprocess (WB dynamics of the "
          f"synthetic quadruped), init + {N_MHPC_SERVED - 1} updates, sim z "
          f"{min(s['z'] for s in steps):.3f}..{max(s['z'] for s in steps):.3f}"
          f" m; received {len(info)} solver_info (one per solve) and "
          f"{len(interm)} intermediate trajectories ({al_iters} AL "
          f"iterations per solve; the updates run 1 DDP iteration each, "
          f"iters {iters} in the last); MHPC_Command_lcmt {n_bytes} B in "
          f"{len(frame(0, 'MHPC_COMMAND', cmd.encode()))} datagram(s), "
          f"finite, equal to the runtime's after the f32 cast; per step "
          + serve_text(steps, served, cfg.dt_mpc * 1e3) + f" [{label}]",
          flush=True)
    ep.close()
    client.close()


# Phase 9: the offline trajectory-optimization path on the synthetic
# quadruped, f64 unless it says otherwise
# the barrel roll's budget: the golden's 6 AL x 8 DDP
# (tools/freeze_goldens.py:115) takes ~70 s a solve on the card, three
# solves over phase 9's time; barrel_roll_demo runs it
BR_OPTS = SolverOptions(max_AL_iter=2, max_DDP_iter=4)
BR_RTOL = 1e-8          # kernel vs twin barrel-roll solve, f64
# the kernel path of phase 9's solves: gathered resets, sequential line
# search, the sweep and linroll kernels
BR_KW = dict(fused_riccati=True, parallel_line_search=False,
             max_resets=MAX_RESETS)
PUSH_B = 64
PUSH_SIGMA = 0.2        # m/s, per axis of the body's linear velocity
PUSH_OPTS = SolverOptions(max_AL_iter=2, max_DDP_iter=2)
LOCO_OPTS = SolverOptions(max_AL_iter=2, max_DDP_iter=4)
IK_TOL = 1e-8           # stance foot against its target
RUN_JUMP_FLIGHT_S = 0.3  # the run-jump's one flight is longer than this
BR_REF_AL = 4           # 9f: AL iterations (the JAX test's 8, cut for time)


def info_text(info, b=0):
    """Iterations and the first and last cost of scenario b."""
    n = min(int(info.n_entries[b]), info.cost_buf.shape[1])
    return (f"iters {int(info.iters[b])}, ls {int(info.ls_iters[b])}, reg "
            f"{int(info.reg_iters[b])}, cost {float(info.cost_buf[b, 0]):.6g}"
            f" -> {float(info.cost_buf[b, n - 1]):.6g}")


def roll_max(Xbar, plan_np):
    """The largest roll angle x[5] over the plan's active knots, per
    scenario."""
    act = torch.as_tensor(plan_np.knot.active > 0, device=Xbar.device)
    return Xbar[:, act, 5].amax(1)


def phase_references(label, model, tmp):
    """9a: the generator and the acrobatic references on the card; checks
    the stance feet against their targets, the CSV round trip, the roll
    and the run-jump's one flight.  Returns the flypace CSV's path."""
    refs = {
        "trot 1.5 s": lambda: generator.generate_reference(
            "trot", duration=1.5, vx=0.5, transition_time=1.0, model=model),
        "pace 1.0 s": lambda: generator.generate_reference(
            "pace", duration=1.0, vx=0.2, model=model),
        "flypace 1.2 s": lambda: generator.generate_reference(
            "flypace", duration=1.2, model=model),
        "barrel roll": lambda: acrobatic.generate_barrel_roll_reference(
            model=model),
        "run-jump 2+2 bounds": lambda: acrobatic.generate_run_jump_reference(
            2, 2, model=model)}
    texts, made = [], {}
    for name, make in refs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = made[name] = make()
        sec = time.perf_counter() - t0
        q = torch.as_tensor(np.concatenate([ref.body_state[:, :6], ref.qJ],
                                           1), device=DEVICE)
        pf = rbda.foot_kinematics(model, q).reshape(len(ref), 12).cpu()
        stance = np.repeat(ref.contact > 0, 3, axis=1)
        err = float(np.abs(pf.numpy() - ref.foot_placements)[stance].max())
        csv = os.path.join(tmp, name.split()[0] + ".csv")
        generator.write_quad_reference_csv(ref, csv)
        same = np.array_equal(load_quad_reference(csv).contact, ref.contact)
        texts.append(f"{name}: {len(ref)} knots in {sec:.2f} s, stance foot "
                     f"err {err:.2e}, csv contacts equal {same}")
        if not (err <= IK_TOL and same and np.isfinite(ref.qJ).all()):
            fail(f"the {name} reference is off: foot err {err:.3e}, csv "
                 f"contacts equal {same}")
    roll_end = made["barrel roll"].body_state[-1, 5]
    fly = made["run-jump 2+2 bounds"].contact.sum(1) == 0
    edges = np.flatnonzero(np.diff(np.r_[0, fly, 0]))
    flights = (edges[1::2] - edges[0::2]) * made["run-jump 2+2 bounds"].dt
    print(f"[9a] references on the card (f64, IK {generator.N_IK_STEPS} "
          f"Newton steps a knot): " + "; ".join(texts) + f"; roll ends at "
          f"{roll_end:.6f} rad; run-jump flights > {RUN_JUMP_FLIGHT_S} s: "
          f"{int((flights > RUN_JUMP_FLIGHT_S).sum())} [{label}]",
          flush=True)
    if abs(roll_end - 2 * np.pi) > 1e-12 \
            or int((flights > RUN_JUMP_FLIGHT_S).sum()) != 1:
        fail("the barrel roll or the run-jump reference has the wrong shape")
    return os.path.join(tmp, "flypace.csv")


def phase_barrel_roll(label, model, setting_dir):
    """9b: the barrel-roll TO at B=1 in f64 on the synthetic settings,
    golden budget, through the sweep and linroll kernels (one warm-up
    solve keeping the first sweep's and linroll's operands, one timed
    solve with the counts set to 0 just before and read just after), then
    through the plain twins; 9c: the two kernels against their twins on
    the warm-up's operands.  Returns the kernels' figures at the
    barrel-roll shape, the solve's (result, cost, success), the first
    sweep's operands and the problem (fns, solver inputs)."""
    plan_np, _, args = ex_br.problem(setting_dir, DEVICE)
    fns = br.make_barrel_roll_fns(model)
    kw = BR_KW
    solve_c, seen = capturing_solver(fns, BR_OPTS, **kw)
    t0 = time.perf_counter()
    solve_c(*args).cost.cpu()
    warm_s = time.perf_counter() - t0
    solve = make_batched_solver(fns, BR_OPTS, **kw)
    reset_counts()
    res, cost, success, ms = timed_solves(solve, args, 1, warmup=False)
    launches = read_counts()
    n_reset = int(plan_np.step.is_reset.sum())
    print(f"[9b] barrel-roll TO ({len(plan_np.step.active)} steps: "
          f"{n_reset} resets, {plan_np.knot.is_terminal.sum():.0f} phases), "
          f"B=1 f64, {BR_OPTS.max_AL_iter} AL x {BR_OPTS.max_DDP_iter} DDP: "
          f"solve {ms[0] / 1e3:.2f} s (warm-up {warm_s:.2f} s); success "
          f"{bool(success[0])}, {info_text(res.info)}, feas "
          f"{float(res.feas[0]):.4g}, max_tconstr "
          f"{float(res.max_tconstr[0]):.4g}, roll max "
          f"{float(roll_max(res.Xbar, plan_np)[0]):.4f} rad; kernel launches "
          f"in the solve {launches} [{label}]", flush=True)
    if not (bool(success[0]) and bool(torch.isfinite(cost).all())):
        fail("the barrel-roll solve failed")
    missed = [k for k in PATH_KERNELS if launches[k] == 0]
    if missed:
        fail(f"kernels of the barrel-roll path were never launched: {missed}")

    solve_p = make_batched_solver(fns, BR_OPTS, plain_ops=True, **kw)
    reset_counts()
    res_p, cost_p, success_p, ms_p = timed_solves(solve_p, args, 1,
                                                  warmup=False)
    if any(read_counts().values()):
        fail(f"the plain-twin barrel roll launched kernels: {read_counts()}")
    same_it = all(torch.equal(getattr(res.info, f), getattr(res_p.info, f))
                  for f in ("iters", "ls_iters", "reg_iters"))
    dc = float(((cost - cost_p) / cost_p).abs().max())
    dX = float((res.Xbar - res_p.Xbar).abs().max())
    print(f"[9b] barrel roll through the plain twins: solve "
          f"{ms_p[0] / 1e3:.2f} s; success {bool(success_p[0])}, "
          f"{info_text(res_p.info)}; kernel vs plain: iteration counts equal "
          f"{same_it}, max |dXbar| {dX:.3e}, cost rel diff {dc:.3e} (tol "
          f"{BR_RTOL:g}) [{label}]", flush=True)
    if not (torch.equal(success, success_p) and same_it and dc <= BR_RTOL):
        fail("the barrel-roll kernel solve disagrees with its twin solve")
    stage_text(label, fns, args, res)
    figs = path_kernel_figures(seen, label, "9c", "barrel-roll",
                               (torch.float64,))
    figs["launches"] = launches
    figs.update(solve=(res, cost, success), sweep_ops=seen["sweep"],
                problem=(fns, args))
    return figs


def stage_clock(fns, args, **kw):
    """One barrel-roll solve with a synchronizing timer around each problem
    function and each kernel wrapper: ({stage: [ms, calls]}, wall ms)."""
    clock = {}

    def timed(name, f):
        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a)
            torch.cuda.synchronize()
            c = clock.setdefault(name, [0.0, 0])
            c[0] += (time.perf_counter() - t0) * 1e3
            c[1] += 1
            return out
        return call
    real = {"sweep": sweep_mod.sweep, "linroll": linroll_mod.linroll}
    sweep_mod.sweep = timed("sweep", real["sweep"])
    linroll_mod.linroll = timed("linroll", real["linroll"])
    try:
        solve = make_batched_solver(fns._replace(**{
            n: timed(n, getattr(fns, n)) for n in fns._fields}), BR_OPTS,
            **kw)
    finally:
        sweep_mod.sweep, linroll_mod.linroll = real["sweep"], real["linroll"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve(*args).cost.cpu()
    return clock, (time.perf_counter() - t0) * 1e3


def stage_text(label, fns, args, res):
    """9b's solve by stage, and one WB linearization on the card (device
    only) at the solved trajectory."""
    clock, wall = stage_clock(fns, args, **BR_KW)
    rest = wall - sum(ms for ms, _ in clock.values())
    plan = args[0]
    prof = profile_device(lambda: fns.dyn_partials(
        res.Xbar[:, :-1], res.Ubar, plan.step)[0].cpu(), host=False)
    print(f"[9b] one barrel-roll solve by stage (a synchronizing timer "
          f"around each problem function and kernel wrapper; {wall:.1f} ms "
          f"clocked): " + ", ".join(
              f"{k} {ms:.1f} ms x{n} ({ms / wall:.1%})" for k, (ms, n) in
              sorted(clock.items(), key=lambda kv: -kv[1][0]))
          + f", the rest of the solver {rest:.1f} ms; one WB linearization "
          f"(B=1, {plan.n_steps} knots): "
          + profile_text(prof, "dyn_partials (device only)")
          + f" [{label}]", flush=True)


def phase_barrel_roll_push(label, model32, model64, setting_dir):
    """9d: the batched barrel roll under push disturbances (BASELINE
    config 4): B=64, f32, the body's linear velocity perturbed by
    N(0, PUSH_SIGMA^2) per axis (seed 0); one timed solve, one profiled
    on the device; failures solved again in f64; the twin solve."""
    plan_np, _, args = ex_br.problem(setting_dir, DEVICE, torch.float32)
    x0 = np.tile(br.initial_state(), (PUSH_B, 1))
    x0[:, 18:21] += np.random.default_rng(SEED).normal(0, PUSH_SIGMA,
                                                       (PUSH_B, 3))
    plan, pen, _, Xbar0, Ubar0 = args
    args = (plan, broadcast_batch(convert.scenario(pen, 0), PUSH_B),
            torch.as_tensor(x0, device=DEVICE, dtype=torch.float32),
            broadcast_batch(Xbar0[0], PUSH_B),
            broadcast_batch(Ubar0[0], PUSH_B))
    fns = br.make_barrel_roll_fns(model32)
    kw = BR_KW
    solve = make_batched_solver(fns, PUSH_OPTS, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, cost, success, ms = timed_solves(solve, args, 1, warmup=False)
    launches = read_counts()
    prof = profile_device(lambda: solve(*args).cost.cpu(), host=False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ok = success & torch.isfinite(cost)
    rolls = roll_max(res.Xbar, plan_np)[ok.to(DEVICE)]
    print(f"[9d] barrel roll under pushes, B={PUSH_B} f32, "
          f"{PUSH_OPTS.max_AL_iter} AL x {PUSH_OPTS.max_DDP_iter} DDP: "
          f"{ms[0]:.1f} ms per batched solve ({PUSH_B / (ms[0] / 1e3):.2f} "
          f"solves/s); {solve_text(res, cost, success)}; roll max "
          f"{float(rolls.min()):.3f}-{float(rolls.max()):.3f} rad over the "
          f"successes; kernel launches {launches}; "
          f"{profile_text(prof, 'one solve (device only)')}; peak device "
          f"memory {peak:.2f} GiB [{label}]", flush=True)
    missed = [k for k in PATH_KERNELS if launches[k] == 0]
    if missed or not bool(ok.any()):
        fail(f"the pushed barrel roll: no success, or kernels never "
             f"launched: {missed}")
    bad = ~ok
    if bool(bad.any()):
        idx = bad.nonzero().flatten().to(DEVICE)
        _, _, (plan64, pen64, _, Xbar64, Ubar64) = ex_br.problem(setting_dir,
                                                                 DEVICE)
        n = idx.numel()
        res64 = make_batched_solver(br.make_barrel_roll_fns(model64),
                                    PUSH_OPTS, **kw)(
            plan64, broadcast_batch(convert.scenario(pen64, 0), n),
            args[2][idx].double(), broadcast_batch(Xbar64[0], n),
            broadcast_batch(Ubar64[0], n))
        ok64 = res64.success.cpu() & torch.isfinite(res64.cost.cpu())
        print(f"[9d] the {int(bad.sum())} scenarios that fail in f32 "
              f"({bad.nonzero().flatten().tolist()}), solved in f64: success "
              f"{ok64.tolist()} [{label}]", flush=True)

    solve_p = make_batched_solver(fns, PUSH_OPTS, plain_ops=True, **kw)
    reset_counts()
    res_p, cost_p, success_p, ms_p = timed_solves(solve_p, args, 1,
                                                  warmup=False)
    if any(read_counts().values()):
        fail(f"the plain-twin pushed solve launched kernels: "
             f"{read_counts()}")
    both = torch.isfinite(cost) & torch.isfinite(cost_p)
    dc = float(((cost - cost_p) / cost_p)[both].abs().max())
    same_it = torch.equal(res.info.iters, res_p.info.iters)
    same_ls = torch.equal(res.info.ls_iters, res_p.info.ls_iters)
    print(f"[9d] pushed barrel roll through the plain twins: {ms_p[0]:.1f} "
          f"ms; {solve_text(res_p, cost_p, success_p)}; kernel vs plain: "
          f"success flags equal {torch.equal(success, success_p)}, iters "
          f"equal per scenario {same_it} (ls iters {same_ls}), cost rel "
          f"diff {dc:.3e} (tol {COST_RTOL:g}) [{label}]", flush=True)
    if not (torch.equal(success, success_p) and same_it
            and dc <= COST_RTOL):
        fail("the pushed barrel roll disagrees with its twin solve")


def phase_loco(label, model, csv):
    """9e: the locomotion TO on the generated flypace reference: plan_dur_wb
    1.0 s, the MHPC in-code default weights with the loco constraint set,
    B=1, f64."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    s, plan, meta, _ = lp.solve_loco_to(
        csv, model, cfg=ex_loco.default_config(), opts=LOCO_OPTS,
        device=DEVICE)
    cost, success = s.cost.cpu(), s.success.cpu()
    sec = time.perf_counter() - t0
    launches = read_counts()
    st = plan.step
    n_dyn = int((st.active * (1 - st.is_reset)).sum())
    print(f"[9e] loco TO (flypace, {len(meta['wb_phases'])} WB phases, "
          f"{n_dyn} WB dynamics steps, {int(st.is_reset.sum())} resets), B=1 "
          f"f64, {LOCO_OPTS.max_AL_iter} AL x {LOCO_OPTS.max_DDP_iter} DDP: "
          f"{sec:.2f} s; success {bool(success[0])}, {info_text(s.info)}, "
          f"feas {float(s.feas[0]):.4g}, max_pconstr "
          f"{float(s.max_pconstr[0]):.4g}, max_tconstr "
          f"{float(s.max_tconstr[0]):.4g}; kernel launches {launches} "
          f"[{label}]", flush=True)
    if n_dyn != 100 or not (bool(success[0]) and bool(
            torch.isfinite(cost).all())):
        fail("the loco TO failed")
    if any(launches[k] == 0 for k in PATH_KERNELS):
        fail(f"kernels of the loco path were never launched: {launches}")


def phase_br_reference(label, model):
    """9f: the MHPC cascade over the in-place barrel-roll reference, window
    [0.25, 0.85] s, B=1, f64, the in-code MHPC defaults."""
    t0 = time.perf_counter()
    ref = ex_brref.reference(model)
    ref_s = time.perf_counter() - t0
    cfg, plan_np, meta, args = ex_brref.problem(ref, DEVICE)
    solve = make_batched_solver(
        mp.make_mhpc_fns_segmented(cfg, model),
        SolverOptions(max_AL_iter=BR_REF_AL), fused_riccati=True,
        parallel_line_search=False, max_resets=ex_brref.MAX_RESETS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = convert.scenario(convert.to_numpy(solve(*args)), 0)
    sec = time.perf_counter() - t0
    launches = read_counts()
    flights, armed, roll = ex_brref.checks(res, plan_np, meta)
    print(f"[9f] MHPC cascade over the in-place barrel-roll reference "
          f"(generated in {ref_s:.2f} s; window [{ex_brref.T_START}, "
          f"{ex_brref.T_START + ex_brref.PLAN_DUR_WB}] s, WB phases "
          f"{[(p[2], p[3].tolist()) for p in meta['wb_phases']]}), B=1 f64, "
          f"{BR_REF_AL} AL: {sec:.2f} s; success {bool(res.success)}, cost "
          f"{float(res.cost):.6g}, feas {float(res.feas):.4g}, iters "
          f"{int(res.info.iters)}; flight phases {len(flights)}, touchdown "
          f"AL entries armed {armed}; roll max {roll:.4f} rad; kernel "
          f"launches {launches} [{label}]", flush=True)
    if not (flights and armed >= 4 and bool(res.success)
            and np.isfinite(float(res.cost))):
        fail("the barrel-roll reference solve failed its checks")
    if any(launches[k] == 0 for k in PATH_KERNELS):
        fail(f"kernels of the br-reference path were never launched: "
             f"{launches}")


def phase_trajopt(label):
    """Phase 9 (9a-9f) on the synthetic quadruped and the synthetic
    barrel-roll settings, in a temporary directory.  Returns the sweep's
    and linroll's figures at the barrel-roll shape."""
    with tempfile.TemporaryDirectory() as tmp:
        urdf = synthetic_robot.write_synthetic_quadruped_urdf(tmp)
        setting_dir = write_synthetic_br_settings(os.path.join(tmp, "br"))
        m64 = wbm.load_model(urdf, DEVICE, torch.float64)
        m32 = wbm.load_model(urdf, DEVICE, torch.float32)
        csv = phase_references(label, m64, tmp)
        figs = phase_barrel_roll(label, m64, setting_dir)
        phase_barrel_roll_push(label, m32, m64, setting_dir)
        phase_loco(label, m64, csv)
        phase_br_reference(label, m64)
    return figs


# Phase 10: the JAX package's default solver configuration (masked resets,
# the exact sequential sweep, the scan linear rollout, the batched line
# search) and the solver's other plain-PyTorch stages on the card
N_SWEEP_TIMED = 5      # 10b: calls per timing of one B=1 sweep
# 10b: a sweep against the exact sequential sweep, normalized by the exact
# one's max |value|.  The scan and the kernel reassociate the recursion, and
# the gains K = -Quu^-1 Qux carry that rounding amplified by Quu's
# conditioning (pivots down to ~1e-3 on these operands in the CPU
# rehearsal: G, H <= 1.3e-8, K <= 5.2e-7)
PLAIN_SWEEP_TOL = {"G": 1e-7, "H": 1e-7, "K": 1e-5}
LQ_CHUNK = 16          # 10e: knots per LQ piece
# 10e's depth, cut from 7c's 4 AL to fit the script's time: a piece of 16
# knots redispatches the whole WB linearization, ~4.5x 7c's solve time
CHUNK_OPTS = SolverOptions(max_AL_iter=1, max_DDP_iter=1)
N_LQ_CHECK = 2         # 10e: scenarios of the chunked-vs-unchunked LQ check
# 10e: the chunked LQ stage against the unchunked one, normalized by the
# unchunked one's max |value|: f64 the same to rounding; f32 within the f32
# kernel tolerance (cuBLAS picks its GEMM kernels by batch size, so a
# piece of 16 knots need not round as the whole horizon does)
CHUNK_LQ_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
BR_RTOL_10F = 1e-6     # 10f: cost against 9b's solve (f64)


def plain_solve_text(res, cost, success, ref_cost, ref_success):
    """Iterations, and the cost against a reference solve's over the
    scenarios where both are finite."""
    both = torch.isfinite(cost) & torch.isfinite(ref_cost)
    dc = float(((cost - ref_cost) / ref_cost)[both].abs().max())
    return dc, (f"{solve_text(res, cost, success)}; success flags equal "
                f"{torch.equal(success, ref_success)}, cost rel diff "
                f"{dc:.3e}")


def phase_jax_default_hkd(label, unfused):
    """10a: the hkd-B256-f32 plan of phase 3b under the JAX defaults, then
    with parallel_riccati=True: timed solves, one profiled solve; no
    kernel launches; success flags equal to 3b's, cost within
    COST_RTOL."""
    args, _ = bench_problem(torch.float32)
    _, cost_3b, success_3b = unfused
    for name, kw in (("JAX defaults", {}),
                     ("parallel_riccati=True", dict(parallel_riccati=True))):
        solve = make_batched_solver(hp.make_hkd_fns(), OPTS,
                                    trim_output=True, reg_floor=1e-3, **kw)
        reset_counts()
        res, cost, success, ms = timed_solves(solve, args, N_TIMED)
        prof = profile_device(lambda: solve(*args).cost.cpu(), host=False)
        launched = read_counts()
        med = statistics.median(ms)
        dc, text = plain_solve_text(res, cost, success, cost_3b, success_3b)
        print(f"[10a] hkd B={B} f32, {name} (masked resets, "
              f"{'scan' if kw else 'exact sequential'} sweep, scan linear "
              f"rollout, batched line search): {B / (med / 1e3):.1f} "
              f"solves/s, median {med:.2f} ms per batched solve (each: "
              f"{', '.join(f'{m:.2f}' for m in ms)}); {text} against 3b "
              f"(tol {COST_RTOL:g}); kernel launches {launched}; "
              f"{profile_text(prof, 'one solve (device only)')} [{label}]",
              flush=True)
        if any(launched.values()):
            fail(f"the {name} solve launched kernels: {launched}")
        if not torch.equal(success, success_3b) or not dc <= COST_RTOL:
            fail(f"the hkd solve under {name} disagrees with phase 3b's")


def sweep_stage_inputs(ops):
    """The sweep kernel's operands (the cost streams merged, the output
    terms folded) as the solver's sweep stages read them: (plan fields,
    TrajState).  Every stage reads lx/lxx on dynamics steps and phix/phixx
    on transform steps, so both hold the merged streams."""
    A, Bm, lx, lu, lxx, luu, lux, phix_T, phixx_T, defect, w = ops
    Bsz, N, xs = lx.shape
    us = lu.shape[-1]
    tr = hsddp.init_traj(types.SimpleNamespace(n_steps=N), xs, us, 0,
                         A.new_zeros(Bsz, N + 1, xs),
                         A.new_zeros(Bsz, N, us))
    tr = tr._replace(A=A, B=Bm, lx=lx, lu=lu, lxx=lxx, luu=luu, lux=lux,
                     phix=torch.cat([lx, phix_T[:, None]], 1),
                     phixx=torch.cat([lxx, phixx_T[:, None]], 1),
                     Defect=defect)
    plan = types.SimpleNamespace(step=types.SimpleNamespace(
        is_reset=w.to(A.dtype), active=torch.ones_like(w, dtype=A.dtype)))
    return plan, tr


def phase_b1_sweeps(label, name, captured):
    """10b: the sweep kernel, the exact sequential sweep and the
    associative-scan sweep on one solve's captured first sweep operands
    (B=1, f64): all ok, each against the exact sweep to PLAIN_SWEEP_TOL;
    profiler device ms and CUDA-event ms per call."""
    *ops, reg = captured
    plan, tr = sweep_stage_inputs(ops)
    stages = make_solver(hp.make_hkd_fns(), SolverOptions())
    runs = {"kernel": lambda: stages._backward_sweep_fused(plan, tr, reg, ops),
            "exact": lambda: stages._backward_sweep(plan, tr, reg),
            "scan": lambda: stages._backward_sweep_parallel(plan, tr, reg)}
    outs = {k: f() for k, f in runs.items()}
    oks = {k: bool(o[3][0]) for k, o in outs.items()}
    w = ops[-1] > 0
    us = ops[3].shape[-1]
    Quu = outs["exact"][0][5][:, ~w]
    L = torch.linalg.cholesky(Quu - 1e-9 * torch.eye(us, device=DEVICE,
                                                     dtype=Quu.dtype))
    d_min = float(torch.diagonal(L, dim1=-2, dim2=-1).pow(2).min())
    every = torch.ones(1, dtype=torch.bool, device=DEVICE)
    errs = {k: {f: errors(outs[k][0][i], outs["exact"][0][i], every)[1]
                for i, f in ((0, "G"), (1, "H"), (2, "K"))}
            for k in ("kernel", "scan")}
    times = {}
    for k, f in runs.items():
        prof = profile_device(lambda: (f(), torch.cuda.synchronize()),
                              host=False)
        dev_ms = (kernel_ms(f, N_SWEEP_TIMED, "sweep_kernel") if k == "kernel"
                  else prof[2] if prof else float("nan"))
        times[k] = (dev_ms, f"{prof[0]} launches" if prof
                    else "launches not measured", time_ms(f, N_SWEEP_TIMED))
    N, xs = ops[2].shape[1:]
    print(f"[10b] {name} sweep operands (B=1 f64, N={N}, xs={xs}, us={us}, "
          f"{int(w.sum())} transform steps, reg {float(reg[0]):g}): ok "
          f"{oks}; against the exact sweep, normalized: " + "; ".join(
              f"{k} " + ", ".join(f"{f} {e:.3e}" for f, e in v.items())
              for k, v in errs.items())
          + f" (tol {PLAIN_SWEEP_TOL}; the pivot rule's 1e-9/d_min "
          f"{1e-9 / d_min:.3e}); per call: " + "; ".join(
              f"{k} device {d:.4f} ms ({n}), event {e:.4f} ms"
              for k, (d, n, e) in times.items()) + f" [{label}]", flush=True)
    if not all(oks.values()):
        fail(f"a B=1 sweep on the {name} operands is not ok: {oks}")
    bad = {k: v for k, v in errs.items()
           if any(not e <= PLAIN_SWEEP_TOL[f] for f, e in v.items())}
    if bad:
        fail(f"sweeps disagree with the exact sweep on the {name} operands: "
             f"{bad}")
    return dict(plan=plan, tr=tr, reg=reg, exact=outs["exact"],
                scan=times["scan"])


def phase_single_shooting(label):
    """10c: single shooting (opts.MS=False, all_shooting=False) on the HKD
    runtime plan at B=1 in f64, 2 AL x 3 DDP: success, feas < 1e-8, the
    final cost at or below the first."""
    args, _ = bench_problem(torch.float64)
    args = (args[0],) + tuple(convert.scenario(a, slice(0, 1)) for a in
                              args[1:])
    opts = SolverOptions(MS=False, max_AL_iter=2, max_DDP_iter=3)
    solve = make_batched_solver(hp.make_hkd_fns(), opts, all_shooting=False)
    reset_counts()
    res, cost, success, ms = timed_solves(solve, args, 1, warmup=False)
    n = int(res.info.n_entries[0])
    first, last = (float(res.info.cost_buf[0, i]) for i in (0, n - 1))
    feas = float(res.feas[0])
    print(f"[10c] single shooting, hkd runtime plan B=1 f64, 2 AL x 3 DDP: "
          f"{ms[0]:.1f} ms per solve; success {bool(success[0])}, "
          f"{info_text(res.info)}, feas {feas:.3e}; kernel launches "
          f"{read_counts()} [{label}]", flush=True)
    if not (bool(success[0]) and feas < 1e-8 and last <= first):
        fail("the single-shooting solve failed, kept a defect, or ended "
             "above its first cost")


def phase_mhpc_masked(label, models, mhpc):
    """10d: phase 7a's mhpc-B256-f32 solve with masked resets and the
    batched line search, the sweep and linroll kernels kept: one timed
    solve, launches, peak memory; success flags equal to 7a's, cost
    within COST_RTOL."""
    f32 = torch.float32
    cfg, args, _ = mhpc_problem(MHPC_B, f32, mhpc_cfg, 0.75, 2.0)
    solve = make_batched_solver(mp.make_mhpc_fns_segmented(cfg, models[f32]),
                                MHPC_OPTS, trim_output=True,
                                fused_riccati=True, reg_floor=1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, cost, success, ms = timed_solves(solve, args, 1, warmup=False)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dc, text = plain_solve_text(res, cost, success, *mhpc["solve"])
    print(f"[10d] mhpc B={MHPC_B} f32, masked resets and the batched line "
          f"search (rollout batch {MHPC_B * 3}), sweep and linroll "
          f"kernels: {ms[0]:.1f} ms per batched solve; {text} against 7a "
          f"(tol {COST_RTOL:g}); kernel launches {launches}; peak device "
          f"memory {peak:.2f} GiB [{label}]", flush=True)
    missed = [k for k in PATH_KERNELS if launches[k] == 0]
    if missed:
        fail(f"kernels of the masked mhpc path were never launched: {missed}")
    if not torch.equal(success, mhpc["solve"][1]) or not dc <= COST_RTOL:
        fail("the masked mhpc solve disagrees with phase 7a's")


def chunked_lq_errors(models):
    """The LQ stage with lq_knot_chunk=LQ_CHUNK against the unchunked one
    on the cascade500 plan's initial trajectory, N_LQ_CHECK scenarios, in
    f64 and f32: {dtype: largest error over the LQ fields, normalized}."""
    errs = {}
    for dtype in (torch.float64, torch.float32):
        cfg, args, _ = mhpc_problem(N_LQ_CHECK, dtype, cascade500_cfg, 7.6,
                                    8.0)
        plan, pen, _, Xbar0, Ubar0 = args
        fns = mp.make_mhpc_fns_segmented(cfg, models[dtype])
        tr = hsddp.init_traj(plan, mp.XS, mp.US, mp.YS, Xbar0, Ubar0)
        got, want = (make_solver(fns, MHPC_OPTS, lq_knot_chunk=c)
                     ._lq_approx(plan, None, pen, tr) for c in (LQ_CHUNK,
                                                                 None))
        every = torch.ones(N_LQ_CHECK, dtype=torch.bool, device=DEVICE)
        errs[dtype] = max(errors(getattr(got, f), getattr(want, f), every)[1]
                          for f in ("A", "B", "C", "D", "lx", "lu", "ly",
                                    "lxx", "luu", "lux", "lyy", "phix",
                                    "phixx"))
    return errs


def phase_cascade500_chunked(label, models):
    """10e: the cascade500 solve of 7c at CHUNK_OPTS, unchunked and with
    lq_knot_chunk=LQ_CHUNK: ms and peak device memory of each; success
    flags equal, cost within COST_RTOL; and the chunked LQ stage against
    the unchunked one (chunked_lq_errors) to CHUNK_LQ_TOL."""
    cfg, args, _ = mhpc_problem(CASCADE_B, torch.float32, cascade500_cfg,
                                7.6, 8.0)
    fns = mp.make_mhpc_fns_segmented(cfg, models[torch.float32])
    runs = {}
    for chunk in (None, LQ_CHUNK):
        solve = make_batched_solver(fns, CHUNK_OPTS, max_resets=32,
                                    lq_knot_chunk=chunk, **MHPC_KW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, cost, success, ms = timed_solves(solve, args, 1, warmup=False)
        runs[chunk] = (res, cost, success, ms[0],
                       torch.cuda.max_memory_allocated() / 2 ** 30)
    del solve, args
    (_, cost_u, success_u, ms_u, peak_u), (res, cost, success, ms, peak) = \
        runs[None], runs[LQ_CHUNK]
    dc, text = plain_solve_text(res, cost, success, cost_u, success_u)
    lq_errs = chunked_lq_errors(models)
    print(f"[10e] cascade500 B={CASCADE_B} f32, {CHUNK_OPTS.max_AL_iter} AL "
          f"x {CHUNK_OPTS.max_DDP_iter} DDP, with lq_knot_chunk={LQ_CHUNK}: "
          f"{ms:.1f} ms per batched solve, peak device memory {peak:.2f} GiB "
          f"(unchunked: {ms_u:.1f} ms, {peak_u:.2f} GiB); {text} against "
          f"the unchunked solve (tol {COST_RTOL:g}); the LQ stage chunked "
          f"vs unchunked on the plan's initial trajectory, B={N_LQ_CHECK}, "
          f"normalized: " + ", ".join(
              f"{str(d)[6:]} {e:.3e} (tol {CHUNK_LQ_TOL[d]:g})"
              for d, e in lq_errs.items()) + f" [{label}]", flush=True)
    if not torch.equal(success, success_u) or not dc <= COST_RTOL:
        fail("the chunked cascade500 solve disagrees with the unchunked one")
    if any(not e <= CHUNK_LQ_TOL[d] for d, e in lq_errs.items()):
        fail(f"the chunked LQ stage disagrees with the unchunked one: "
             f"{lq_errs}")


def phase_barrel_roll_defaults(label, trajopt):
    """10f: 9b's barrel roll (B=1 f64, BR_OPTS) under the JAX demo's
    configuration, the make_solver defaults: one timed solve; success and
    iteration counts equal to 9b's, cost within BR_RTOL_10F."""
    fns, args = trajopt["problem"]
    res_9b, cost_9b, success_9b = trajopt["solve"]
    solve = make_batched_solver(fns, BR_OPTS)
    reset_counts()
    res, cost, success, ms = timed_solves(solve, args, 1, warmup=False)
    same_it = all(torch.equal(getattr(res.info, f), getattr(res_9b.info, f))
                  for f in ("iters", "ls_iters", "reg_iters"))
    dc = float(((cost - cost_9b) / cost_9b).abs().max())
    print(f"[10f] barrel roll B=1 f64, {BR_OPTS.max_AL_iter} AL x "
          f"{BR_OPTS.max_DDP_iter} DDP, the JAX demo's configuration (the "
          f"make_solver defaults): solve {ms[0] / 1e3:.2f} s; success "
          f"{bool(success[0])}, {info_text(res.info)}; against 9b: "
          f"iteration counts equal {same_it}, cost rel diff {dc:.3e} (tol "
          f"{BR_RTOL_10F:g}); kernel launches {read_counts()} [{label}]",
          flush=True)
    if not (torch.equal(success, success_9b) and same_it
            and dc <= BR_RTOL_10F):
        fail("the barrel roll under the JAX defaults disagrees with 9b's")


def phase_plain_stages(label, unfused, models, mhpc, trajopt):
    """Phase 10 (10a-10f).  Returns 10b's operands, exact sweeps and scan
    times by name of the operands."""
    phase_jax_default_hkd(label, unfused)
    args, _ = bench_problem(torch.float64)
    args = (args[0],) + tuple(convert.scenario(a, slice(0, 1)) for a in
                              args[1:])
    solve_c, seen = capturing_solver(hp.make_hkd_fns(), SolverOptions(),
                                     **dict(SOLVE_KW, reg_floor=0.0))
    solve_c(*args).cost.cpu()
    b1 = {name: phase_b1_sweeps(label, name, ops) for name, ops in (
        ("hkd runtime plan", seen["sweep"]),
        ("barrel-roll (9b)", trajopt["sweep_ops"]))}
    phase_single_shooting(label)
    phase_mhpc_masked(label, models, mhpc)
    phase_cascade500_chunked(label, models)
    phase_barrel_roll_defaults(label, trajopt)
    return b1


# Phase 11: the batched scenario sweep (BASELINE config 5,
# cafempc_tpu_torch/tools/scenario_sweep.py) and the scale-out layer
# (parallel/{mesh, knot_riccati}.py)
SWEEP_CHUNK = 256      # 11a-11b: scenarios a chunk (the tool's default)
SWEEP_TOTAL = 512      # 11a: 2 chunks of the chain: warm-up + timed
SWEEP_CHAIN = 2        # 11a: plans a chain (the tool's default is 4)
SWEEP_TWIN_B = 8       # 11a: the kernel chain against its twin chain
KNOT_BLOCKS = 4        # 11c-11d: knot blocks on the one card
N_MESH_TIMED = 3       # 11d-11e: timed solves of each configuration


def sweep_text(r):
    """The tool's summary figures of one case."""
    keys = ("success_rate", "cost_p50", "cost_p95", "solves_per_s",
            "timed_solves", "timed_seconds", "iters_mean", "ls_iters_mean",
            "ls_iters_max", "reg_iters_mean", "reg_iters_max")
    feas = ("dyn_feas_p50_by_step" if "dyn_feas_p50_by_step" in r
            else "dyn_feas_p50")
    return ", ".join(f"{k} {r[k]}" for k in keys) + f", {feas} {r[feas]}"


def recording(solve, log):
    """solve(...) that also keeps each result."""
    def run(*args):
        log.append(solve(*args))
        return log[-1]
    return run


def sweep_chain(model, csv, cfg, fns, opts, batch, total, seen_bs=None,
                plain_ops=False, on_timed=None):
    """The tool's run_case_chain on the gait CSV at SWEEP_CHAIN plans (f32,
    the tool's mhpc keywords, rng seed 0): (summary, solve results, the
    propagated states)."""
    qr = ss.quad_ref(csv, ss.MHPC_WINDOW)
    steps, props = ss.mhpc_chain(qr, cfg, model, DEVICE, torch.float32,
                                 SWEEP_CHAIN)
    states, log = [], []
    kept = [lambda x, U, p=p: states.append(p(x, U)) or states[-1]
            for p in props]
    solve = make_batched_solver(fns, opts, plain_ops=plain_ops, **ss.MHPC_KW)
    r = ss.run_case_chain(recording(solve, log), None, steps, total, batch,
                          np.random.default_rng(SEED), torch.float32, kept,
                          seen_bs=seen_bs, on_timed=on_timed)
    return r, log, states


def phase_sweep_mhpc(label, models, tmp):
    """11a: the mhpc sweep's MPC chain on a generated bound gait at B=256:
    one warm-up chunk and one timed chunk, the kernels' launches counted
    over the timed chunk; all costs and propagated states finite.  Then
    the same chain at B=8 through the kernels and through their twins:
    equal success flags and iteration counts, cost within COST_RTOL.
    Returns the gait CSV and the timed chunk's launches."""
    f32 = torch.float32
    t0 = time.perf_counter()
    csv, made = ss.gait_csv(os.path.join(tmp, "refs"), "bound",
                            models[torch.float64])
    gen_s = time.perf_counter() - t0
    cfg, opts, settings = ss.mhpc_settings()
    fns = mp.make_mhpc_fns_segmented(cfg, models[f32])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r, log, states = sweep_chain(models[f32], csv, cfg, fns, opts,
                                 SWEEP_CHUNK, SWEEP_TOTAL,
                                 on_timed=reset_counts)
    launches = read_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = (all(bool(torch.isfinite(s.cost).all()) for s in log),
              all(bool(torch.isfinite(x).all()) for x in states))
    print(f"[11a] mhpc sweep chain (bound gait generated {made} in "
          f"{gen_s:.1f} s; {settings}), {SWEEP_CHAIN} plans a scenario, "
          f"chunk {SWEEP_CHUNK}, f32, {r['n_scenarios']} scenarios in "
          f"{wall:.1f} s (a warm-up chunk, then {r['timed_solves']} timed "
          f"solves): {sweep_text(r)}; kernel launches in the timed "
          f"chunk {launches}; costs finite {finite[0]}, propagated states "
          f"finite {finite[1]}; peak device memory {peak:.2f} GiB "
          f"[{label}]", flush=True)
    missed = [k for k in PATH_KERNELS if launches[k] == 0]
    if missed:
        fail(f"kernels of the sweep chain were never launched in its timed "
             f"chunk: {missed}")
    if not all(finite):
        fail("the sweep chain gave a non-finite cost or state")
    runs = {}
    for plain in (False, True):
        reset_counts()
        t0 = time.perf_counter()
        runs[plain] = sweep_chain(models[f32], csv, cfg, fns, opts,
                                  SWEEP_TWIN_B, SWEEP_TWIN_B * SWEEP_CHAIN,
                                  seen_bs={SWEEP_TWIN_B}, plain_ops=plain)
        runs[plain] += (read_counts(), time.perf_counter() - t0)
    (_, log_k, _, n_k, s_k), (_, log_p, _, n_p, s_p) = runs[False], \
        runs[True]
    pairs = [same_solves((a, a.cost, a.success), (b, b.cost, b.success))
             for a, b in zip(log_k, log_p)]
    same, dc = all(p[0] for p in pairs), max(p[1] for p in pairs)
    print(f"[11a] the chain at B={SWEEP_TWIN_B}, kernels ({s_k:.1f} s, "
          f"launches {n_k}) vs twins ({s_p:.1f} s, launches {n_p}): success "
          f"flags and iteration counts equal at every step {same}, cost rel "
          f"diff {dc:.3e} (tol {COST_RTOL:g}) [{label}]", flush=True)
    if any(n_p.values()) or min(n_k[k] for k in PATH_KERNELS) == 0:
        fail("the B=8 chains launched the wrong kernels")
    if not (same and dc <= COST_RTOL):
        fail("the sweep chain through the kernels disagrees with its twin")
    return csv, launches


def phase_sweep_hkd(label, csv):
    """11b: the hkd sweep's one-shot solves (the JAX defaults, 2 AL x 1
    DDP) on the generated bound gait at B=256: a warm-up chunk and a timed
    one."""
    opts, settings = ss.hkd_settings()
    fns, plan, pen, x0, Xb, Ub = ss.build_hkd_case(csv, DEVICE,
                                                   torch.float32)
    solve = make_batched_solver(fns, opts, trim_output=True)
    reset_counts()
    t0 = time.perf_counter()
    r = ss.run_case(solve, None, plan, pen, x0, Xb, Ub, 2 * SWEEP_CHUNK,
                    SWEEP_CHUNK, np.random.default_rng(SEED), torch.float32)
    print(f"[11b] hkd sweep (bound gait, {int(plan.step.is_reset.sum())} "
          f"resets; {settings}), chunk {SWEEP_CHUNK}, f32, {r['n']} "
          f"scenarios in {time.perf_counter() - t0:.1f} s: {sweep_text(r)}; "
          f"kernel launches {read_counts()} [{label}]", flush=True)
    if r["success_rate"] != 1.0 or not np.isfinite(r["cost_p95"]):
        fail("an hkd sweep scenario failed")


def phase_knot_sweeps(label, b1):
    """11c: the knot-sharded sweep at B=1 in f64 on 10b's operands, its
    KNOT_BLOCKS blocks on the one card: against the exact sweep to
    PLAIN_SWEEP_TOL; device ms, launches and CUDA-event ms per call beside
    10b's scan sweep."""
    stages = make_solver(hp.make_hkd_fns(), SolverOptions(), knot_axis="knot",
                         knot_shards=KNOT_BLOCKS,
                         knot_devices=[torch.device(DEVICE)] * KNOT_BLOCKS)
    every = torch.ones(1, dtype=torch.bool, device=DEVICE)
    for name, d in b1.items():
        reset_counts()
        f = lambda: stages._backward_sweep_knot(d["plan"], d["tr"], d["reg"])
        out = f()
        launched = read_counts()
        errs = {k: errors(out[0][i], d["exact"][0][i], every)[1]
                for i, k in ((0, "G"), (1, "H"), (2, "K"))}
        prof = profile_device(lambda: (f(), torch.cuda.synchronize()),
                              host=False)
        dev_ms = prof[2] if prof else float("nan")
        n_l = f"{prof[0]} launches" if prof else "launches not measured"
        ev = time_ms(f, N_SWEEP_TIMED)
        sd, sn, se = d["scan"]
        print(f"[11c] knot-sharded sweep, {KNOT_BLOCKS} blocks on the card, "
              f"{name} operands (B=1 f64): ok {bool(out[3][0])}; against the "
              f"exact sweep, normalized: " + ", ".join(
                  f"{k} {e:.3e}" for k, e in errs.items())
              + f" (tol {PLAIN_SWEEP_TOL}); per call: device {dev_ms:.4f} ms "
              f"({n_l}), event {ev:.4f} ms; 10b's scan sweep: device "
              f"{sd:.4f} ms ({sn}), event {se:.4f} ms; kernel launches "
              f"{launched} [{label}]", flush=True)
        if not bool(out[3][0]) or any(not e <= PLAIN_SWEEP_TOL[k]
                                      for k, e in errs.items()):
            fail(f"the knot-sharded sweep disagrees with the exact sweep on "
                 f"the {name} operands: {errs}")
        if any(launched.values()):
            fail(f"the knot-sharded sweep launched kernels: {launched}")
        print(f"[11c] the same in f32 against the f64 exact sweep, "
              f"{name} operands, normalized K error: " + ", ".join(
                  f"{k} {e:.3e}" for k, e in f32_k_errors(d, stages).items())
              + f" [{label}]", flush=True)


def f32_k_errors(d, knot_stages):
    """The gains K of the exact, scan and knot-sharded sweeps run in f32
    on 10b's operands, each against the f64 exact sweep's, normalized."""
    tr = hsddp.TrajState(*[t.float() if torch.is_tensor(t)
                           and t.is_floating_point() else t for t in d["tr"]])
    reg = d["reg"].float()
    stages = make_solver(hp.make_hkd_fns(), SolverOptions())
    runs = {"exact": stages._backward_sweep,
            "scan": stages._backward_sweep_parallel,
            "knot": knot_stages._backward_sweep_knot}
    every = torch.ones(1, dtype=torch.bool, device=DEVICE)
    return {k: errors(f(d["plan"], tr, reg)[0][2].double(), d["exact"][0][2],
                      every)[1] for k, f in runs.items()}


def same_solves(a, b):
    """Success flags and iteration counts equal; the cost rel diff."""
    same = torch.equal(a[2], b[2]) and all(
        torch.equal(getattr(a[0].info, f), getattr(b[0].info, f))
        for f in ("iters", "ls_iters", "reg_iters"))
    both = torch.isfinite(a[1]) & torch.isfinite(b[1])
    return same, float(((a[1] - b[1]) / b[1])[both].abs().max())


def phase_meshes(label, unfused):
    """11d: 3b's plan and keywords with the knot-sharded sweep in place of
    the sweep kernel, over a (scenario 1, knot KNOT_BLOCKS) mesh of the one
    card, against the same keywords with parallel_riccati and no mesh;
    11e: 3b's solve itself through a scenario mesh of the visible cards,
    equal to 3b's bit for bit."""
    args, _ = bench_problem(torch.float32)
    card_dev = torch.device(DEVICE)
    kw = dict(SOLVE_KW, fused_riccati=False, fused_linroll=True)
    runs = {}
    for name, extra in (
            ("knot mesh", dict(mesh=mesh_mod.scenario_knot_mesh(
                1, KNOT_BLOCKS, devices=[card_dev] * KNOT_BLOCKS))),
            ("parallel_riccati", dict(parallel_riccati=True))):
        solve = make_batched_solver(hp.make_hkd_fns(), OPTS, **kw, **extra)
        reset_counts()
        res, cost, success, ms = timed_solves(solve, args, N_MESH_TIMED)
        runs[name] = (res, cost, success, statistics.median(ms),
                      read_counts())
    same, dc = same_solves(runs["knot mesh"], runs["parallel_riccati"])
    print(f"[11d] hkd B={B} f32, 3b's keywords with the sweep kernel "
          f"replaced: " + "; ".join(
              f"{k}: median {r[3]:.2f} ms per solve, success "
              f"{int(r[2].sum())}/{B}, launches over {N_MESH_TIMED + 1} "
              f"solves {r[4]}" for k, r in runs.items())
          + f"; success flags and iteration counts equal {same}, cost rel "
          f"diff {dc:.3e} (tol {COST_RTOL:g}) [{label}]", flush=True)
    if not (same and dc <= COST_RTOL) or int(runs["knot mesh"][2].sum()) != B:
        fail("the knot-mesh solve disagrees with the parallel_riccati solve")
    mesh = mesh_mod.scenario_mesh()
    solve = make_batched_solver(hp.make_hkd_fns(), OPTS, mesh=mesh,
                                **SOLVE_KW)
    reset_counts()
    res, cost, success, ms = timed_solves(solve, args, N_MESH_TIMED)
    launches = read_counts()
    ref = unfused[0]
    equal = {f: torch.equal(getattr(res, f), getattr(ref, f))
             for f in ("Xbar", "Ubar", "K", "cost", "success", "feas")}
    equal["info"] = all(torch.equal(a, b) for a, b in zip(res.info,
                                                          ref.info))
    print(f"[11e] 3b's solve through scenario_mesh() ({mesh}): median "
          f"{statistics.median(ms):.2f} ms per solve; launches over "
          f"{N_MESH_TIMED + 1} solves {launches}; bit for bit equal to 3b's "
          f"{equal} [{label}]", flush=True)
    if not all(equal.values()):
        fail(f"the meshed 3b solve is not 3b's: {equal}")


def phase_sweep(label, models, b1, unfused):
    """Phase 11 (11a-11e); returns 11a's launches in its timed chunk."""
    with tempfile.TemporaryDirectory() as tmp:
        csv, launches = phase_sweep_mhpc(label, models, tmp)
        phase_sweep_hkd(label, csv)
    phase_knot_sweeps(label, b1)
    phase_meshes(label, unfused)
    return launches


# Phase 12: the MHPC joint mode and MHPCRuntime(segmented=False) on the
# card; then the HKD-MPC demo's closed loop
RT_RTOL = 1e-7          # 12e: joint against segmented runtime commands
N_DEMO_STEPS = 10       # 12f: MPC steps of the demo's closed loop
DEMO_GAIT_S = 2.0       # 12f: s of generated pace


def profiled_solve(solve, args, profile=True):
    """One solve, with the launch counts set to 0 just before it and read
    just after, under the device-only profiler unless profile=False:
    (result, cost, success, ms of the solve and the fetch of its cost and
    success on the host clock, counts, profile or None)."""
    out = {}

    def run():
        t0 = time.perf_counter()
        out["res"] = solve(*args)
        out["cost"] = out["res"].cost.cpu()
        out["success"] = out["res"].success.cpu()
        out["ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    reset_counts()
    prof = profile_device(run, host=False) if profile else run()
    return (out["res"], out["cost"], out["success"], out["ms"],
            read_counts(), prof)


def against_7a(tag, what, res, cost, success, mhpc):
    """Fails unless the solve has 7a's success flags and iteration counts
    per scenario and its cost within COST_RTOL; returns the text."""
    dc, text = plain_solve_text(res, cost, success, *mhpc["solve"])
    same_it = all(torch.equal(getattr(res.info, f).cpu(),
                              getattr(mhpc["info"], f).cpu())
                  for f in ("iters", "ls_iters", "reg_iters"))
    if not (torch.equal(success, mhpc["solve"][1]) and same_it
            and dc <= COST_RTOL):
        fail(f"{tag}: the {what} solve disagrees with phase 7a's (success "
             f"flags, iteration counts equal {same_it}, cost {dc:.3e})")
    return f"{text}, iteration counts equal per scenario {same_it} (7a)"


def phase_mhpc_joint(label, models, mhpc):
    """12d: the mhpc-B256-f32 solve with the joint-mode functions
    (`make_mhpc_fns(cfg, model)`) and 7a's keywords: a warm-up keeping the
    first sweep and linroll operands, one solve profiled on the device
    with the launch counts set to 0 just before and read just after,
    against 7a's; then the two kernels against their twins on the captured
    operands.  Returns the kernels' figures at this path."""
    f32 = torch.float32
    cfg, args, _ = mhpc_problem(MHPC_B, f32, mhpc_cfg, 0.75, 2.0)
    fns = mp.make_mhpc_fns(cfg, models[f32])
    kw = dict(MHPC_KW, max_resets=MAX_RESETS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solve_c, seen = capturing_solver(fns, **kw)
    solve_c(*args).cost.cpu()
    warm_s = time.perf_counter() - t0
    solve = make_batched_solver(fns, MHPC_OPTS, **kw)
    res, cost, success, ms, counts, prof = profiled_solve(solve, args)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[12d] mhpc joint mode (make_mhpc_fns), B={MHPC_B} f32, 7a's "
          f"keywords: {ms:.1f} ms for one solve (device-only profiler on; "
          f"warm-up {warm_s:.1f} s); "
          + against_7a("12d", "joint", res, cost, success, mhpc)
          + f"; kernel launches {counts}; "
          + profile_text(prof, "the solve (device only)")
          + f"; peak device memory {peak:.2f} GiB [{label}]", flush=True)
    missed = [k for k in PATH_KERNELS if counts[k] == 0]
    if missed:
        fail(f"kernels of the joint mhpc path were never launched: {missed}")
    figs = path_kernel_figures(seen, label, tag="12d", what="mhpc joint")
    figs["launches"] = counts
    return figs


def tape_rel_errors(got, want):
    """Max |got - want| / max |want| of each command-tape field."""
    out = {}
    for f in ("torque", "pos", "eul", "qJ", "vWorld", "eulrate", "qJd",
              "GRF", "feedback", "Qu", "Quu", "Qux"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        out[f] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    return out


def phase_runtime_joint(label, model, steps):
    """12e: MHPCRuntime(segmented=False) at 7b's configuration, B=1 f64,
    initialize + N_RT_UPDATES updates on 7b's states: commands against
    7b's to RT_RTOL; each step's build, solve and fetch ms."""
    qr = QuadReference(synthetic_bound_reference_urdf(duration=2.0))
    qr.initialize(0.75)
    rt = MHPCRuntime(qr, mp.MHPCConfig(), SolverOptions(), model=model,
                     device=DEVICE, dtype=torch.float64, segmented=False)
    lines, worst = [], 0.0
    reset_counts()
    for i, (x, want) in enumerate(steps):
        tape = rt.initialize(x) if i == 0 else rt.update(x)
        t = rt.timing
        err = max(tape_rel_errors(tape, want).values())
        worst = max(worst, err)
        lines.append(f"{'init' if i == 0 else f'update {i}'} build "
                     f"{t['build_ms']:.1f} + solve {t['solve_ms']:.1f} + "
                     f"fetch {t['fetch_ms']:.1f} ms, success "
                     f"{bool(rt.result['success'])}, command rel err "
                     f"{err:.3e}")
    counts = read_counts()
    print(f"[12e] MHPC runtime segmented=False (joint functions), B=1 f64, "
          f"on 7b's states: " + "; ".join(lines) + f"; kernel launches "
          f"{counts} (tol {RT_RTOL:g} against 7b's commands) [{label}]",
          flush=True)
    if not worst <= RT_RTOL:
        fail(f"the joint runtime's commands differ from 7b's: {worst:.3e}")
    if not all(counts[k] for k in PATH_KERNELS):
        fail(f"the joint runtime launched no sweep or linroll: {counts}")


def phase_demo(label):
    """12f: the HKD-MPC demo's closed loop on the card
    (`examples/hkd_mpc_demo.py` without its plots): a pace generated on
    the synthetic quadruped, HKDMPCRuntime f64, N_DEMO_STEPS MPC steps
    against the HKD plant; the height must stay in the demo's range and
    every cost be finite."""
    cfg = hp.HKDConfig()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        qr = QuadReference(ex_demo.reference("pace", None, tmp, DEVICE,
                                             DEMO_GAIT_S))
        gen_s = time.perf_counter() - t0
    qr.initialize(cfg.plan_duration)
    rt = HKDMPCRuntime(qr, cfg, ex_demo.OPTS, device=DEVICE)
    steps = []
    reset_counts()
    X, _ = ex_demo.closed_loop(
        rt, ex_demo.initial_state(qr, DEVICE), N_DEMO_STEPS,
        lambda i, x, tape: steps.append((float(tape.solve_info["cost"][-1]),
                                         dict(rt.timing))))
    counts = read_counts()
    z = X[:, 5]
    ms = [t["build_ms"] + t["solve_ms"] + t["fetch_ms"] for _, t in steps]
    ok = bool(np.isfinite([c for c, _ in steps]).all()) and bool(
        ((z > ex_demo.Z_RANGE[0]) & (z < ex_demo.Z_RANGE[1])).all())
    print(f"[12f] HKD-MPC demo closed loop on the card: pace generated in "
          f"{gen_s:.1f} s, {N_DEMO_STEPS} MPC steps, z "
          f"{z.min():.3f}-{z.max():.3f} m (range {ex_demo.Z_RANGE}), cost "
          f"first/last {steps[0][0]:.2f}/{steps[-1][0]:.2f}, ms per update "
          f"(build + solve + fetch) median {statistics.median(ms):.1f}, max "
          f"{max(ms):.1f}; kernel launches {counts} [{label}]", flush=True)
    if not ok:
        fail("the demo's closed loop left the height range or a cost is not "
             "finite")
    if not all(counts[k] for k in PATH_KERNELS):
        fail(f"the demo's runtime launched no sweep or linroll: {counts}")


def phase_options(label, models, mhpc):
    """Phase 12 (12d-12f); returns 12d's kernel figures."""
    joint = phase_mhpc_joint(label, models, mhpc)
    phase_runtime_joint(label, models[torch.float64], mhpc["runtime"])
    phase_demo(label)
    return joint


# Phase 13: the JAX package's last HKD surface (the settings loaders) and
# config 5's arcdog half
RT_SETTINGS_TOL = 1e-10  # 13c: commands against phase 5's, normalized
N_RT_SETTINGS = 3       # 13c: updates after the initialize
ARCDOG_CHUNK = 64       # 13d: scenarios a chunk
ARCDOG_CHAIN = 2        # 13d: plans a scenario


def hkd_settings_files(root):
    """(constraint_params.info, ddp_setting.info) of root/HKDMPC/settings."""
    d = os.path.join(root, "HKDMPC", "settings")
    return (os.path.join(d, "constraint_params.info"),
            os.path.join(d, "ddp_setting.info"))


def phase_settings_bench(label, root, fused):
    """13a: phase 3's bench default built as the JAX bench builds it
    (bench.py:58-84): the HKDConfig by `load_hkd_constraint_params`, the
    options by `load_solver_options` cut to 2 AL x 1 DDP, the penalties by
    `pen_to_device`, from the stand-in files under `root`; timed solves
    through all four kernels, then against phase 3's solve: success flags
    and iteration counts per scenario equal, cost within COST_RTOL."""
    cp, ddp = hkd_settings_files(root)
    cfg = hp.load_hkd_constraint_params(cp, hp.HKDConfig(
        plan_duration=PLAN_DURATION, n_steps_max=N_STEPS))
    opts = dataclasses.replace(load_solver_options(ddp), max_AL_iter=2,
                               max_DDP_iter=1)
    args, meta = bench_problem(torch.float32, cfg, pen_to_device=True)
    res, cost, success, _, per_solve = phase_solve(
        label, "13a", "from the settings files", args, meta, fused_hooks(),
        KERNELS, opts=opts)
    same, dc = same_solves((res, cost, success), fused)
    print(f"[13a] settings {os.path.dirname(cp)} (stand-in: the in-code "
          f"defaults written by write_synthetic_hkd_settings): against "
          f"phase 3's solve success flags and iteration counts equal per "
          f"scenario {same}, cost rel diff {dc:.3e} (tol {COST_RTOL:g}); "
          f"launches per solve {per_solve} [{label}]", flush=True)
    if not (same and dc <= COST_RTOL):
        fail("13a: the solve from the settings files disagrees with phase "
             "3's")
    return per_solve


def phase_runtime_settings(label, root, steps):
    """13c: HKDMPCRuntime built with no device argument from 13a's files
    at phase 5's plan, initialize + N_RT_SETTINGS updates on phase 5's
    states: every solve on the card, commands within RT_SETTINGS_TOL of
    phase 5's."""
    cp, ddp = hkd_settings_files(root)
    cfg = hp.load_hkd_constraint_params(cp, hp.HKDConfig(
        plan_duration=PLAN_DURATION, n_steps_max=N_STEPS))
    qr = QuadReference(synthetic_bound_reference(duration=2.0))
    qr.initialize(PLAN_DURATION)
    rt = HKDMPCRuntime(qr, cfg, load_solver_options(ddp))
    devices = set()
    for name in ("solve_init", "solve_rt"):
        solve = getattr(rt, name)
        setattr(rt, name, lambda plan, pen, *b, _s=solve: devices.update(
            t.device.type for t in (plan.step.dt, pen.reb_delta, *b))
            or _s(plan, pen, *b))
    reset_counts()
    lines, worst = [], 0.0
    for i, (x, want) in enumerate(steps[:N_RT_SETTINGS + 1]):
        got = rt.initialize(x) if i == 0 else rt.update(x)
        err = max(float(np.abs(np.asarray(getattr(got, f), float)
                                - np.asarray(getattr(want, f), float)).max()
                        / max(np.abs(np.asarray(getattr(want, f),
                                                float)).max(), 1e-30))
                  for f in ("times", "controls", "des_body_state",
                            "feedback", "contacts", "status_times",
                            "foot_placements"))
        worst = max(worst, err)
        t = rt.timing
        lines.append(f"{'init' if i == 0 else f'update {i}'} build "
                     f"{t['build_ms']:.1f} + solve {t['solve_ms']:.1f} + "
                     f"fetch {t['fetch_ms']:.1f} ms, command rel err "
                     f"{err:.3e}")
    counts = read_counts()
    print(f"[13c] HKDMPCRuntime(qr, cfg, opts) from the settings files, no "
          f"device argument: device {rt.device!r}, solves' tensors on "
          f"{sorted(devices)}; " + "; ".join(lines) + f"; kernel launches "
          f"{counts} (tol {RT_SETTINGS_TOL:g} against phase 5's commands) "
          f"[{label}]", flush=True)
    if devices != {torch.device(DEVICE).type}:
        fail(f"13c: the runtime's solves ran on {devices}")
    if not worst <= RT_SETTINGS_TOL:
        fail(f"13c: the runtime's commands differ from phase 5's: "
             f"{worst:.3e}")
    if not all(counts[k] for k in PATH_KERNELS):
        fail(f"13c: the runtime launched no sweep or linroll: {counts}")


def phase_arcdog(label, tmp):
    """13d: the arcdog half of the `mhpc` sweep (the tool's --arcdog-urdf
    path: `arcdog_models`, `arcdog_quad_ref`, `mhpc_chain`,
    `run_case_chain`, one solver for the robot), given the synthetic
    quadruped's URDF as a stand-in for the arcdog's: both ARCDOG_GAITS
    generated on the card, chains of ARCDOG_CHAIN plans, chunks of
    ARCDOG_CHUNK, 11a's keywords; every cost and propagated state finite.
    Returns the launches of the last gait's timed chunk per solve."""
    f32 = torch.float32
    urdf = synthetic_robot.write_synthetic_quadruped_urdf(
        os.path.join(tmp, "arcdog_standin"))
    models = ss.arcdog_models(urdf, DEVICE)
    cfg, opts, settings = ss.mhpc_settings()
    log, states, seen = [], [], set()
    solve = recording(make_batched_solver(
        mp.make_mhpc_fns_segmented(cfg, models[f32]), opts, **ss.MHPC_KW),
        log)
    rng = np.random.default_rng(SEED)
    for gait in ss.ARCDOG_GAITS:
        t0 = time.perf_counter()
        qr = ss.arcdog_quad_ref(gait, ss.MHPC_WINDOW, models[torch.float64])
        gen_s = time.perf_counter() - t0
        steps, props = ss.mhpc_chain(qr, cfg, models[f32], DEVICE, f32,
                                     ARCDOG_CHAIN)
        kept = [lambda x, U, p=p: states.append(p(x, U)) or states[-1]
                for p in props]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = ss.run_case_chain(solve, None, steps,
                              ARCDOG_CHUNK * ARCDOG_CHAIN, ARCDOG_CHUNK,
                              rng, f32, kept, seen_bs=seen,
                              on_timed=reset_counts)
        launches = read_counts()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per_solve = {k: v / (r["timed_solves"] // ARCDOG_CHUNK)
                     for k, v in launches.items()}
        print(f"[13d] arcdog/{gait} (STAND-IN: the synthetic quadruped's "
              f"URDF given as --arcdog-urdf, the arcdog's is not in the "
              f"repository; gait generated in memory on the card in "
              f"{gen_s:.1f} s with {ss.ARCDOG_GEN_KW}; {settings}), "
              f"{ARCDOG_CHAIN} plans a scenario, chunk {ARCDOG_CHUNK}, f32, "
              f"{r['n_scenarios']} scenarios in {wall:.1f} s: "
              f"{sweep_text(r)}; kernel launches in the timed chunk "
              f"{launches}, per batched solve {per_solve}; peak device "
              f"memory {peak:.2f} GiB [{label}]", flush=True)
        if not all(launches[k] for k in PATH_KERNELS):
            fail(f"13d: the arcdog chain launched no sweep or linroll in "
                 f"its timed chunk: {launches}")
    finite = (all(bool(torch.isfinite(s.cost).all()) for s in log),
              all(bool(torch.isfinite(x).all()) for x in states))
    print(f"[13d] arcdog half: {len(log)} batched solves, costs finite "
          f"{finite[0]}, {len(states)} propagated state batches finite "
          f"{finite[1]} [{label}]", flush=True)
    if not all(finite):
        fail("13d: an arcdog chain gave a non-finite cost or state")
    return per_solve


def phase_hkd_surface(label, fused, steps5):
    """Phase 13 (13a, 13c, 13d); returns the launches per solve of 13a and
    13d."""
    with tempfile.TemporaryDirectory() as tmp:
        root = write_synthetic_hkd_settings(tmp)
        launches = {"13a": phase_settings_bench(label, root, fused)}
        phase_runtime_settings(label, root, steps5)
        launches["13d"] = phase_arcdog(label, tmp)
    return launches


def timed_phase(n, fn, label, *args):
    """fn(label, *args), printing its wall seconds as phase n's."""
    t0 = time.perf_counter()
    out = fn(label, *args)
    print(f"[t] phase {n} took {time.perf_counter() - t0:.1f} s [{label}]",
          flush=True)
    return out


def phase_kernels_all(label):
    """Phase 2: every kernel against its twin (2, then the B=1 and xs=36
    shapes, then the HKD kernels); returns the f32 figures."""
    f32 = phase_kernels(label)
    check_sweep_b1(label)
    check_linroll_shapes(label)
    f32.update(phase_hkd_kernels(label))
    return f32


def phase_mhpc_all(label, models):
    """Phase 7 (7a-7c); returns 7a's figures, 7b's steps under
    "runtime"."""
    mhpc = phase_mhpc(label, models)
    mhpc["runtime"] = phase_mhpc_runtime(label, models[torch.float64])
    phase_cascade500(label, models[torch.float32])
    return mhpc


def phase_serving(label, models):
    """Phase 8 (8a-8d)."""
    phase_wire(label)
    phase_serve_hkd(label)
    phase_serve_mhpc(label, models[torch.float64])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs only "
              "on the GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = card()
    print(f"[0] card: {label}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    so, build_s, log = _ext.build(force=True)
    print(f"[1] built {so.name} with nvcc for sm_90a in {build_s:.1f} s; "
          + " | ".join(l.strip() for l in log.splitlines()
                       if "registers" in l or "Compiling entry" in l
                       or "spill" in l),
          flush=True)
    print(f"[t] phase 1 took {time.perf_counter() - t0:.1f} s [{label}]",
          flush=True)
    f32 = timed_phase(2, phase_kernels_all, label)
    launches, unfused, fused = timed_phase(3, phase_solves, label)
    args, _ = bench_problem(torch.float64)
    steps5 = timed_phase(5, phase_runtime, label, args[2][0].cpu().numpy())
    timed_phase(6, phase_models, label)
    models = mhpc_models()
    mhpc = timed_phase(7, phase_mhpc_all, label, models)
    timed_phase(8, phase_serving, label, models)
    trajopt = timed_phase(9, phase_trajopt, label)
    b1 = timed_phase(10, phase_plain_stages, label, unfused, models, mhpc,
                     trajopt)
    chain = timed_phase(11, phase_sweep, label, models, b1, unfused)
    joint = timed_phase(12, phase_options, label, models, mhpc)
    timed_phase(13, phase_hkd_surface, label, fused, steps5)

    print(label)
    # each TPU kernel by its function's `def` line / its pallas_call line
    rows = [("sweep", "cafempc_tpu/ops/fused_sweep.py:202/288"),
            ("linroll", "cafempc_tpu/ops/fused_linroll.py:49/73"),
            ("hkd_lq", "cafempc_tpu/ops/fused_hkd_lq.py:437/521"),
            ("hkd_trial", "cafempc_tpu/ops/fused_hkd_trial.py:317/416")]

    def on_paths(name):
        """The kernel on phase 7a's path at the mhpc solve's shape (f32),
        on 11a's sweep chain at the same shape (launches in its timed
        chunk of 2 x 256 solves), on 12d's joint-mode solve at the same
        shape, and on phase 9b's at the barrel roll's (f64)."""
        if name not in PATH_KERNELS:
            return {}
        return {path: {
            "launches": (chain if path == "sweep_chain"
                         else figs["launches"])[name],
            "max_abs_err": figs[f"{name}_err"], "ms": figs[f"{name}_ms"],
            "plain_ms": figs[f"{name}_plain_ms"],
            "bound_ms": figs[f"{name}_bound"][0],
            "bound_by": figs[f"{name}_bound"][1], "library_ms": None}
            for path, figs in (("mhpc", mhpc), ("sweep_chain", mhpc),
                               ("mhpc_joint", joint),
                               ("barrel_roll", trajopt))}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"cafempc_tpu_torch/ops/csrc/{name}.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": f32[f"{name}_err"], "ms": f32[f"{name}_ms"],
         "event_ms": f32[f"{name}_event_ms"],
         "plain_ms": f32[f"{name}_plain_ms"],
         "bound_ms": f32[f"{name}_bound"][0],
         "bound_by": f32[f"{name}_bound"][1],
         # no single PyTorch call computes any of the four functions
         "library_ms": None, **on_paths(name)}
        for name, replaces in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line of output each, unless noted):
  1. build the CUDA kernels (`cafempc_tpu_torch/ops/csrc/*.cu`) with nvcc
     for sm_90a from this checkout and print the build seconds;
  2. each kernel against its plain PyTorch twin on the card, f32 and f64,
     at the main path's shapes (B=256, N=112, xs=us=24), with transform
     steps and scenarios that fail the PSD check;
  3. the HKD-MPC bench configuration at full width: synthetic bound
     reference, 1.0 s plan (112 steps), B=256 perturbed initial states,
     f32, 2 AL x 1 DDP, sequential line search, reg floor 1e-3, gathered
     resets, the sweep and linroll kernels; one warm-up solve then timed
     solves (CUDA events + a host fetch of cost and success);
  4. the same solve with the plain twins, and the difference between the
     two solves;
  5. the MPC runtime: initialize + 5 updates at B=1, each fed the solver's
     own predicted state;
then the card's name and power limit, one JSON line of the kernels and
the final `{"ok": true, "device": ...}` line.  Exits non-zero, printing
no result, without a CUDA device or when any phase fails.
"""
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from cafempc_tpu_torch import convert
from cafempc_tpu_torch.models import hkd
from cafempc_tpu_torch.ops import _ext
from cafempc_tpu_torch.ops import linroll as linroll_mod
from cafempc_tpu_torch.ops import sweep as sweep_mod
from cafempc_tpu_torch.parallel.mesh import broadcast_batch, make_batched_solver
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.reference.quad_reference import QuadReference
from cafempc_tpu_torch.reference.synthetic import synthetic_bound_reference
from cafempc_tpu_torch.runtime.mpc import HKDMPCRuntime
from cafempc_tpu_torch.solver.options import SolverOptions

DEVICE = "cuda"
B = 256
PLAN_DURATION = 1.0
N_STEPS = 112
N_TIMED = 5
SEED = 0
# kernel vs plain-twin solve in f32: the sweep's sums are reassociated
# along the 112-knot recursion, and the line search carries the difference
COST_RTOL = 1e-3


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sweep_inputs(gen, dtype, n_fail=8):
    """Seeded Riccati-sweep operands at the main path's shapes, with every
    fifth step a transform step and `n_fail` scenarios whose control
    Hessian is negative definite at one dynamics step."""
    xs = us = 24
    dev = DEVICE

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, dtype=torch.float64)
                * s).to(dev, dtype)

    def spd(n, s):
        M = rnd(B, N_STEPS, n, n, s=0.3)
        return M @ M.transpose(-1, -2) + s * torch.eye(n, device=dev,
                                                       dtype=dtype)

    A = torch.eye(xs, device=dev, dtype=dtype) + rnd(B, N_STEPS, xs, xs,
                                                     s=0.02)
    Bm = rnd(B, N_STEPS, xs, us, s=0.05)
    lxx, luu = spd(xs, 0.5), spd(us, 1.0)
    luu[:n_fail, N_STEPS // 2] = -torch.eye(us, device=dev, dtype=dtype)
    w = torch.zeros(N_STEPS, dtype=torch.int32, device=dev)
    w[::5] = 1
    phixx = rnd(B, xs, xs, s=0.3)
    return (A, Bm, rnd(B, N_STEPS, xs, s=0.5), rnd(B, N_STEPS, us, s=0.5),
            lxx, luu, rnd(B, N_STEPS, us, xs, s=0.05),
            rnd(B, xs, s=0.5), phixx @ phixx.transpose(-1, -2),
            rnd(B, N_STEPS + 1, xs, s=0.01), w,
            torch.full((B,), 1e-3, device=dev, dtype=dtype))


def errors(a, b, mask):
    """(max |a - b|, max |a - b| / max |b|) over the scenarios in mask."""
    a, b = a[mask], b[mask]
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-30)


def time_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def phase_kernels(label):
    """Kernel vs twin in f32 and f64; returns the f32 figures."""
    f32 = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        gen = torch.Generator().manual_seed(SEED)
        ins = sweep_inputs(gen, dtype)
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
            f32["sweep_ms"] = time_ms(lambda: sweep_mod.sweep(*ins), 20)
            f32["sweep_plain_ms"] = time_ms(
                lambda: sweep_mod.sweep_reference(*ins), 2)
            args = (M.contiguous(), c, dx0)
            f32["linroll_ms"] = time_ms(lambda: linroll_mod.linroll(*args),
                                        50)
            f32["linroll_plain_ms"] = time_ms(
                lambda: linroll_mod.linroll_reference(*args), 5)
    print(f"[2] f32 times at B={B} N={N_STEPS} xs=us=24 ({label}): sweep "
          f"kernel {f32['sweep_ms']:.3f} ms vs twin "
          f"{f32['sweep_plain_ms']:.3f} ms; linroll kernel "
          f"{f32['linroll_ms']:.4f} ms vs twin "
          f"{f32['linroll_plain_ms']:.3f} ms", flush=True)
    return f32


def bench_problem(dtype):
    """The bench `hkd` configuration (JAX package bench.py:58-84) on the
    synthetic bound reference: plan, penalties, B perturbed x0 and the
    initial trajectory, plus the plan's phase metadata."""
    qr = QuadReference(synthetic_bound_reference(duration=2.0))
    qr.initialize(PLAN_DURATION)
    cfg = hp.HKDConfig(plan_duration=PLAN_DURATION, n_steps_max=N_STEPS)
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
    plan, pen, Xbar0, Ubar0 = convert.from_numpy(
        (plan_np, pen_np, Xbar0, Ubar0), DEVICE, dtype)
    return (plan, broadcast_batch(pen, B), x0_b.to(DEVICE, dtype),
            broadcast_batch(Xbar0, B), broadcast_batch(Ubar0, B)), meta


def timed_solves(solve, args, n):
    """One warm-up solve, then n solves each timed with CUDA events around
    the solve and the host fetch of (cost, success)."""
    res = solve(*args)
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


def phase_solves(label):
    """Phases 3 and 4: the bench configuration with the kernels, then with
    the plain twins.  Returns the kernels' launch counts in phase 3."""
    dtype = torch.float32
    args, meta = bench_problem(dtype)
    opts = SolverOptions(max_AL_iter=2, max_DDP_iter=1)
    kw = dict(trim_output=True, parallel_line_search=False,
              fused_riccati=True, max_resets=16, reg_floor=1e-3)
    solve = make_batched_solver(hp.make_hkd_fns(), opts, **kw)
    sweep_mod.sweep.launches = 0
    linroll_mod.linroll.launches = 0
    res, cost, success, ms = timed_solves(solve, args, N_TIMED)
    launches = {"sweep": sweep_mod.sweep.launches,
                "linroll": linroll_mod.linroll.launches}
    med = statistics.median(ms)
    n_ok = int(success.sum())
    print(f"[3] hkd bench config ({len(meta['phases'])} phases, "
          f"{meta['n_knots']} knots), B={B} f32, kernels: "
          f"{B / (med / 1e3):.1f} solves/s, median {med:.2f} ms per batched "
          f"solve (each: {', '.join(f'{m:.2f}' for m in ms)}); "
          f"success {n_ok}/{B}, cost finite "
          f"{bool(torch.isfinite(cost).all())}, iters "
          f"{res.info.iters[0].item()}, ls {res.info.ls_iters.sum().item()}, "
          f"reg {res.info.reg_iters.sum().item()}; launches {launches} "
          f"[{label}]", flush=True)
    if n_ok != B or not bool(torch.isfinite(cost).all()):
        fail("the kernel solve did not succeed on every scenario")
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path was never launched: {launches}")

    solve_p = make_batched_solver(hp.make_hkd_fns(), opts, plain_ops=True,
                                  **kw)
    res_p, cost_p, success_p, ms_p = timed_solves(solve_p, args, 2)
    med_p = statistics.median(ms_p)
    dX = float((res.Xbar - res_p.Xbar).abs().max())
    dU = float((res.Ubar - res_p.Ubar).abs().max())
    dc = float(((cost - cost_p) / cost_p).abs().max())
    print(f"[4] plain twins: {B / (med_p / 1e3):.1f} solves/s (median "
          f"{med_p:.2f} ms) vs kernels {B / (med / 1e3):.1f} solves/s; "
          f"success {int(success_p.sum())}/{B}; kernel vs plain solve: max "
          f"|dXbar| {dX:.3e}, max |dUbar| {dU:.3e}, cost rel diff "
          f"{dc:.3e} (tol {COST_RTOL:g}) [{label}]", flush=True)
    if not (np.isfinite(dX) and np.isfinite(dU)):
        fail("kernel and plain solves are not finite")
    if not torch.equal(success, success_p) or not dc <= COST_RTOL:
        fail("the kernel solve disagrees with the plain-twin solve")
    return launches


def phase_runtime(label, x0):
    """Phase 5: the MPC runtime at B=1 in f64, initialize + 5 updates, each
    fed the solver's own predicted state one MPC period ahead."""
    qr = QuadReference(synthetic_bound_reference(duration=2.0))
    qr.initialize(PLAN_DURATION)
    cfg = hp.HKDConfig(plan_duration=PLAN_DURATION, n_steps_max=N_STEPS)
    rt = HKDMPCRuntime(qr, cfg, SolverOptions(), device=DEVICE,
                       dtype=torch.float64)
    x, lines = x0, []
    for i in range(6):
        if i == 0:
            rt.initialize(x)
        else:
            rt.update(x)
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

    so, build_s, log = _ext.build(force=True)
    print(f"[1] built {so.name} with nvcc for sm_90a in {build_s:.1f} s; "
          + " | ".join(l.strip() for l in log.splitlines()
                       if "registers" in l or "Compiling entry" in l
                       or "spill" in l),
          flush=True)
    f32 = phase_kernels(label)
    launches = phase_solves(label)
    args, _ = bench_problem(torch.float64)
    phase_runtime(label, args[2][0].cpu().numpy())

    print(label)
    print(json.dumps({"kernels": [
        {"name": "sweep", "route": "cuda",
         "source": "cafempc_tpu_torch/ops/csrc/sweep.cu",
         "replaces": "cafempc_tpu/ops/fused_sweep.py:288",
         "launches": launches["sweep"], "max_abs_err": f32["sweep_err"],
         "ms": f32["sweep_ms"], "plain_ms": f32["sweep_plain_ms"]},
        {"name": "linroll", "route": "cuda",
         "source": "cafempc_tpu_torch/ops/csrc/linroll.cu",
         "replaces": "cafempc_tpu/ops/fused_linroll.py:73",
         "launches": launches["linroll"], "max_abs_err": f32["linroll_err"],
         "ms": f32["linroll_ms"], "plain_ms": f32["linroll_plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched scenario sweep (BASELINE config 5) on the card: thousands of
MHPC cascade solves over gaits x initial-state perturbations x pushes,
each a warm-started MPC chain with a plant step between re-solves (port of
`tools/scenario_sweep.py`).

    python -m cafempc_tpu_torch.tools.scenario_sweep [--total 4096]
        [--chunk 256] [--config mhpc|hkd] [--chain 4] [--out PATH]
        [--ref-dir DIR] [--settings-dir DIR] [--arcdog-urdf PATH]
        [--device cuda|cpu]

Gaits: `--ref-dir` is laid out like the reference's Reference/Data
(`<gait>/quad_reference.csv`, urdf leg order; default: `sweep_refs/`
beside `--out`).  A gait whose CSV is missing is generated there by
`reference/generator.py` on the robot (2.0 s, vx 0.5 m/s, a 0.6 s ramp:
the JAX tool's generated-gait settings at the generator's Mini Cheetah
height), and every gait is then read back from its CSV.  The robot is the
synthetic quadruped (`models/synthetic_robot.py`), standing in for the
Mini Cheetah, whose URDF is not in the repository.  Settings:
`--settings-dir` is laid out like the reference root
(`MHPC/settings/{mhpc_config.info, cost_weights_regular.JSON,
constraint_params_regular.info, ddp_setting.info}`,
`HKDMPC/settings/ddp_setting.info`); without it, the in-code defaults
(`MHPCConfig()`, `SolverOptions()`), with the tool's iteration caps either
way.  The arcdog half (`mhpc` only) runs with `--arcdog-urdf`, the robot's
URDF by path: its gaits are generated in memory on it (`arcdog_quad_ref`:
the JAX tool's 2.0 s, vx 0.5 m/s, height 0.36 m, swing 0.12 m, a 0.6 s
ramp), chained like the mini-cheetah gaits, and solved by a solver of
their own; without the flag they are listed under `skipped`.  The `mhpc`
total is divided over the cases that run.

`mhpc` (default): per gait, a chain of `--chain` receding-horizon plans
`dt_mpc` apart (window 0.75 s: 25 WB + 10 SRB knots), each scenario
cold-started at t0 from the WB reference + N(0, 0.02) noise and a push
N(0, 0.25^2) m/s on the body's linear velocity, then propagated through
the solved controls for one MPC period (the plant: the robot's own WB
dynamics and impacts) and re-solved warm-started from the previous
solution; solved in chunks of `--chunk` scenarios with the JAX bench
keywords (sweep and linroll kernels, sequential line search, 16 gathered
resets, reg floor 1e-3).  `hkd`: one-shot cold starts of the HKD plan
(1.0 s, 112 steps) under the JAX defaults.  In f32 on `--device`; over a
scenario mesh when more than one CUDA device is visible.  Writes one JSON
with the JAX tool's fields per case (success rate, cost and feasibility
percentiles, timed solves/s, iteration statistics) and in total, plus the
data and settings it ran on.
"""
import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from cafempc_tpu_torch.convert import from_numpy
from cafempc_tpu_torch.examples.barrel_roll_demo import device_name
from cafempc_tpu_torch.examples.two_process_hkd_mpc import check_device
from cafempc_tpu_torch.models import hkd, synthetic_robot, wbm
from cafempc_tpu_torch.parallel.mesh import (broadcast_batch,
                                             make_batched_solver, replicate,
                                             scenario_mesh, shard_batch)
from cafempc_tpu_torch.problems import hkd_problem as hp
from cafempc_tpu_torch.problems import mhpc_problem as mp
from cafempc_tpu_torch.reference import generator
from cafempc_tpu_torch.reference.quad_reference import (QuadReference,
                                                        load_quad_reference,
                                                        wb_state_ref_at)
from cafempc_tpu_torch.runtime.warm_start import warm_start_indices
from cafempc_tpu_torch.solver.options import (SolverOptions,
                                              load_solver_options)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (robot, gait) cases of BASELINE config 5
MC_GAITS = ["bound", "pace", "flytrot", "pronk"]
ARCDOG_GAITS = ["trot", "pace"]
HKD_GAITS = ["bound", "pace", "flypace"]
# a missing gait CSV is generated with these (the JAX tool's arcdog
# settings, at the generator's Mini Cheetah height and swing)
GEN_KW = dict(duration=2.0, vx=0.5, transition_time=0.6)
# the arcdog gaits (the JAX tool's _arcdog_quad_ref)
ARCDOG_GEN_KW = dict(GEN_KW, z_des=0.36, swing_height=0.12)
MHPC_WINDOW = 0.75          # s of reference a plan spans (bench.py:87-110)
MHPC_ITERS = dict(max_AL_iter=4, max_DDP_iter=1)   # MHPCLocomotion.cpp:86-87
HKD_ITERS = dict(max_AL_iter=2, max_DDP_iter=1)
# the JAX bench keywords of the mhpc solve (tools/scenario_sweep.py:503-506)
MHPC_KW = dict(trim_output=True, max_resets=16, parallel_line_search=False,
               fused_riccati=True, reg_floor=1e-3)


def gait_csv(ref_dir, gait, model):
    """(path, generated) of `<ref_dir>/<gait>/quad_reference.csv`,
    generating it with GEN_KW on `model` where it is missing."""
    path = os.path.join(ref_dir, gait, "quad_reference.csv")
    if os.path.exists(path):
        return path, False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    generator.write_quad_reference_csv(
        generator.generate_reference(gait, model=model, **GEN_KW), path)
    return path, True


def quad_ref(csv, plan_dur, reorder=False):
    qr = QuadReference(load_quad_reference(csv, reorder=reorder))
    qr.initialize(plan_dur)
    return qr


def arcdog_quad_ref(gait, plan_dur, model):
    """The arcdog gait generated in memory on `model` (urdf leg order) with
    ARCDOG_GEN_KW, initialized to a plan window of `plan_dur`."""
    qr = QuadReference(generator.generate_reference(gait, model=model,
                                                    **ARCDOG_GEN_KW))
    qr.initialize(plan_dur)
    return qr


def arcdog_models(urdf, device):
    """The arcdog whole-body model from its URDF on `device`, f32 and f64;
    a path that is not a file raises."""
    if not os.path.isfile(urdf):
        raise FileNotFoundError(f"--arcdog-urdf: no file at {urdf}")
    return {dt: wbm.load_model(urdf, device, dt)
            for dt in (torch.float32, torch.float64)}


def mhpc_settings(settings_dir=None):
    """(MHPCConfig, SolverOptions with the MHPC iteration caps, source)."""
    if settings_dir is None:
        return (mp.MHPCConfig(), SolverOptions(**MHPC_ITERS),
                f"in-code defaults: MHPCConfig(), SolverOptions() with "
                f"{MHPC_ITERS}")
    d = os.path.join(settings_dir, "MHPC", "settings")
    cfg = mp.load_mhpc_config(os.path.join(d, "mhpc_config.info"))
    cfg = mp.load_cost_weights(os.path.join(d, "cost_weights_regular.JSON"),
                               cfg)
    cfg = mp.load_constraint_params(
        os.path.join(d, "constraint_params_regular.info"), cfg)
    opts = dataclasses.replace(
        load_solver_options(os.path.join(d, "ddp_setting.info")),
        **MHPC_ITERS)
    return cfg, opts, f"{d} with {MHPC_ITERS}"


def hkd_settings(settings_dir=None):
    """(SolverOptions with the HKD iteration caps, source)."""
    if settings_dir is None:
        return SolverOptions(**HKD_ITERS), \
            f"in-code defaults: SolverOptions() with {HKD_ITERS}"
    f = os.path.join(settings_dir, "HKDMPC", "settings", "ddp_setting.info")
    return dataclasses.replace(load_solver_options(f), **HKD_ITERS), \
        f"{f} with {HKD_ITERS}"


def build_mhpc_case(qr, cfg, device, dtype):
    """The cascaded MHPC plan of the reference window at qr's time:
    (plan, pen on `device`, x0 the WB state reference at the window's start
    (numpy), Xbar0, Ubar0 (numpy), the host plan)."""
    plan_np, pen_np, Xbar0, Ubar0, _ = mp.build_mhpc_plan(qr, cfg)
    plan, pen = from_numpy((plan_np, pen_np), device, dtype)
    return plan, pen, wb_state_ref_at(qr, 0.0), Xbar0, Ubar0, plan_np


def build_hkd_case(csv, device, dtype, plan_dur=1.0, n_steps_max=112):
    """The HKD plan on the gait CSV read in Cheetah leg order: (fns, plan,
    pen, x0 the bench pose (numpy), Xbar0, Ubar0)."""
    qr = quad_ref(csv, plan_dur, reorder=True)
    cfg = hp.HKDConfig(plan_duration=plan_dur, n_steps_max=n_steps_max)
    plan_np, pen_np, Xbar0, Ubar0, meta = hp.build_hkd_plan(qr, cfg)
    plan, pen = from_numpy((plan_np, pen_np), device, dtype)
    body = np.zeros(12)
    body[5] = 0.2486
    f64 = torch.float64
    qd = hkd.compute_hkd_state(
        torch.tensor(body[0:3], dtype=f64), torch.tensor(body[3:6],
                                                         dtype=f64),
        torch.tensor([0.0, -0.8, 1.6] * 4, dtype=f64),
        torch.tensor(meta["phases"][0][3], dtype=f64))
    x0 = np.concatenate([body, qd.numpy()])
    return hp.make_hkd_fns(), plan, pen, x0, Xbar0, Ubar0


def _iter_stats(infos):
    """Mean and max of each iteration counter over every solve of a case."""
    out = {}
    for name in ("iters", "ls_iters", "reg_iters"):
        v = np.concatenate([np.asarray(i[name], dtype=float).ravel()
                            for i in infos])
        out[f"{name}_mean"] = round(float(v.mean()), 2)
        out[f"{name}_max"] = int(v.max())
    return out


def make_propagator(model, bg_alpha, plan_np, dt_mpc):
    """Plant step: integrate every scenario's state through its solved
    controls for one MPC period, walking the plan's steps (WB dynamics, and
    the impact at each reset step) until dt_mpc of dynamics time has
    passed.  Returns fn(x_b [B, 36], U_b [B, N, 12]) -> [B, 36] on the
    model's device and dtype, the whole batch at once."""
    step = plan_np.step
    seq = []          # (kind, k) kind: 0 dynamics, 1 reset
    t_acc, k = 0.0, 0
    while t_acc < dt_mpc - 1e-9:
        if step.active[k] < 1:
            break
        if step.is_reset[k] > 0:
            seq.append((1, k))
        else:
            seq.append((0, k))
            t_acc += float(step.dt[k])
        k += 1
    dev, dtype = model.mass.device, model.mass.dtype
    contact = torch.as_tensor(np.asarray(step.contact), dtype=dtype,
                              device=dev)
    contact_next = torch.as_tensor(np.asarray(step.contact_next),
                                   dtype=dtype, device=dev)
    dts = np.asarray(step.dt)

    def prop(x_b, U_b):
        x = x_b
        for kind, kk in seq:
            c = contact[kk].expand(x.shape[0], 4)
            if kind == 0:
                x = wbm.dynamics(model, x, U_b[:, kk], float(dts[kk]), c,
                                 bg_alpha)[0]
            else:
                x = wbm.impact(model, x, c,
                               contact_next[kk].expand(x.shape[0], 4))[0]
        return x
    return prop


def _warm_perm(wmap, old_terminal, new_terminal, n_steps, device):
    """(src, dst) knot mapping -> fixed-shape permutation and mask pairs for
    Xbar ([N+1]) and Ubar ([N]) on `device`: permX[j] = the matched old
    knot (or j), maskX[j] = matched.  A terminal knot doubles as a reset
    step, which carries no control: as in
    runtime/warm_start.time_aligned_warm_start, it neither seeds nor is
    seeded with a Ubar row (the JAX tool's version omits this guard)."""
    src, dst = wmap
    permX = np.arange(len(new_terminal))
    maskX = np.zeros(len(new_terminal), bool)
    permX[dst] = src
    maskX[dst] = True
    permU = np.arange(n_steps)
    maskU = np.zeros(n_steps, bool)
    um = ((dst < n_steps) & (src < n_steps) & ~new_terminal[dst]
          & ~old_terminal[src])
    permU[dst[um]] = src[um]
    maskU[dst[um]] = True
    return tuple(torch.as_tensor(a, device=device)
                 for a in (permX, maskX, permU, maskU))


def _apply_warm(Xb0_b, Ub0_b, prevX, prevU, permX, maskX, permU, maskU):
    """Warm start on the device: gather the previous solution's knots onto
    the new plan through the precomputed permutation (no host sync)."""
    Xb = torch.where(maskX[None, :, None], prevX[:, permX], Xb0_b)
    Ub = torch.where(maskU[None, :, None], prevU[:, permU], Ub0_b)
    return Xb, Ub


def _terminal(plan):
    return plan.knot.is_terminal.cpu().numpy() > 0


def run_case_chain(solve_b, mesh, chain_steps, n_total, chunk, rng, dtype,
                   propagators, seen_bs=None, push_sigma=0.25,
                   noise_sigma=0.02, on_timed=None):
    """Each scenario runs as a warm-started MPC chain: a cold-start solve
    at t0, then per MPC period the state propagated through the solved
    controls (plant = the robot's own WB dynamics) and the advanced plan
    re-solved warm-started from the previous solution.

    chain_steps: [(plan, pen, x0, Xbar0, Ubar0, warm_map)] (plan and pen on
    the solve's device; x0, Xbar0, Ubar0 numpy), warm_map the (src, dst)
    knot mapping from the previous step's plan.  The scenario count is
    rounded up to whole chunks of the chain (every chunk at the full chunk
    size).  The warm start, the plant step and the re-solve stay on the
    device; the telemetry is fetched after every chunk was dispatched.
    seen_bs: batch sizes this solver has already run; the first chunk of a
    new one is a warm-up (kernel build and load, library handles), solved
    and reported but left out of the timed window, and at least one timed
    chunk follows it.  on_timed: called as the timed window opens.  Counts
    every re-solve in the throughput."""
    chain = len(chain_steps)
    if seen_bs is None:
        seen_bs = set()
    n_ok = done = timed = 0
    t_g = 0.0
    infos = []
    costs, feas_final = [], []
    feas_steps = [[] for _ in range(chain)]
    n_scen = max(-(-n_total // chain), 1)
    n_scen = -(-n_scen // chunk) * chunk
    x0_c = chain_steps[0][2]
    device = chain_steps[0][0].step.dt.device

    B = chunk
    n_steps_u = chain_steps[0][4].shape[0]
    step_const = []
    for i, (plan, pen, x0_i, Xbar0, Ubar0, wmap) in enumerate(chain_steps):
        plan_in = replicate(plan, mesh) if mesh is not None else plan
        pen_b = broadcast_batch(pen, B)
        Xb_b0 = broadcast_batch(torch.as_tensor(Xbar0, dtype=dtype,
                                                device=device), B)
        Ub_b0 = broadcast_batch(torch.as_tensor(Ubar0, dtype=dtype,
                                                device=device), B)
        if mesh is not None:
            pen_b = shard_batch(pen_b, mesh)
        perms = (_warm_perm(wmap, _terminal(chain_steps[i - 1][0]),
                            _terminal(plan), n_steps_u, device)
                 if wmap is not None else None)
        step_const.append((plan_in, pen_b, Xb_b0, Ub_b0, perms))

    def dispatch_chunk():
        """One chunk's whole chain; returns its telemetry tensors (not
        fetched here)."""
        x0_b = np.tile(x0_c, (B, 1))
        x0_b += rng.normal(0, noise_sigma, x0_b.shape)
        x0_b[:, 18:21] += rng.normal(0, push_sigma, (B, 3))
        x_b = torch.as_tensor(x0_b, dtype=dtype, device=device)
        prev = None
        handles = []
        for i, (plan_in, pen_b, Xb_b, Ub_b, perms) in \
                enumerate(step_const):
            if prev is not None and perms is not None:
                Xb_b, Ub_b = _apply_warm(Xb_b, Ub_b, prev.Xbar, prev.Ubar,
                                         *perms)
                x_b = propagators[i - 1](x_b, prev.Ubar)
            batch = (x_b, Xb_b, Ub_b)
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            s = solve_b(plan_in, pen_b, *batch)
            prev = s
            handles.append((s.success, s.cost, s.feas,
                            {k: getattr(s.info, k)
                             for k in ("iters", "ls_iters", "reg_iters")}))
        return handles

    def collect(handles):
        nonlocal n_ok
        for i, (succ, cost, feas, info) in enumerate(handles):
            n_ok += int(succ.sum())
            infos.append({k: v.cpu().numpy() for k, v in info.items()})
            feas_steps[i].append(feas.cpu().numpy().astype(float))
            if i == chain - 1:
                costs.append(cost.cpu().numpy().astype(float))
                feas_final.append(feas.cpu().numpy().astype(float))

    if B not in seen_bs:
        seen_bs.add(B)
        collect(dispatch_chunk())
        done += B
    n_scen = max(n_scen, done + B)
    if on_timed is not None:
        on_timed()
    t0 = time.perf_counter()
    pending = []
    while done < n_scen:
        pending.append(dispatch_chunk())
        done += B
    for h in pending:
        collect(h)
    dt = time.perf_counter() - t0
    if pending:
        t_g += dt
        timed += len(pending) * B * chain
    cost_all = np.concatenate(costs)
    feas_all = np.concatenate(feas_final)
    r = dict(
        n_scenarios=done, chain=chain, n_solves=done * chain,
        n_success=n_ok,
        success_rate=round(n_ok / (done * chain), 4),
        cost_p50=round(float(np.median(cost_all)), 3),
        cost_p95=round(float(np.percentile(cost_all, 95)), 3),
        dyn_feas_final_p50=round(float(np.median(feas_all)), 5),
        dyn_feas_final_p95=round(float(np.percentile(feas_all, 95)), 5),
        dyn_feas_p50_by_step=[
            round(float(np.median(np.concatenate(f))), 5)
            for f in feas_steps],
        timed_solves=timed, timed_seconds=round(t_g, 3),
        solves_per_s=round(timed / t_g, 1) if t_g > 0 else None)
    r.update(_iter_stats(infos))
    return r


def run_case(solve_b, mesh, plan, pen, x0, Xb, Ub, n_total, chunk, rng,
             dtype, seen_bs=None, push_sigma=0.25, noise_sigma=0.02):
    """One-shot cold-start solves (the hkd config): chunks of `chunk`
    scenarios (the last one smaller); the first chunk of each new batch
    size is left out of the timed window."""
    device = plan.step.dt.device
    plan_in = replicate(plan, mesh) if mesh is not None else plan
    if seen_bs is None:
        seen_bs = set()
    n_ok, done, t_g, timed = 0, 0, 0.0, 0
    costs, feas = [], []
    infos = []
    while done < n_total:
        B = max(min(chunk, n_total - done), 1)
        timed_chunk = B in seen_bs
        seen_bs.add(B)
        # scenario variation: initial-state noise + a velocity push
        x0_b = np.tile(x0, (B, 1))
        x0_b += rng.normal(0, noise_sigma, x0_b.shape)
        if x0.shape[-1] == 36:            # WB state: vWorld dims 18:21
            x0_b[:, 18:21] += rng.normal(0, push_sigma, (B, 3))
        else:                             # HKD state: vWorld dims 9:12
            x0_b[:, 9:12] += rng.normal(0, push_sigma, (B, 3))
        pen_b = broadcast_batch(pen, B)
        Xb_b = broadcast_batch(torch.as_tensor(Xb, dtype=dtype,
                                               device=device), B)
        Ub_b = broadcast_batch(torch.as_tensor(Ub, dtype=dtype,
                                               device=device), B)
        batch = (pen_b, torch.as_tensor(x0_b, dtype=dtype, device=device),
                 Xb_b, Ub_b)
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        t0 = time.perf_counter()
        s = solve_b(plan_in, *batch)
        succ = s.success.cpu().numpy()
        dt = time.perf_counter() - t0
        if timed_chunk:
            t_g += dt
            timed += B
        n_ok += int(succ.sum())
        infos.append({k: getattr(s.info, k).cpu().numpy()
                      for k in ("iters", "ls_iters", "reg_iters")})
        costs.append(s.cost.cpu().numpy().astype(float))
        feas.append(s.feas.cpu().numpy().astype(float))
        done += B
    cost_all = np.concatenate(costs)
    feas_all = np.concatenate(feas)
    r = dict(
        n=done, n_success=n_ok, success_rate=round(n_ok / done, 4),
        cost_p50=round(float(np.median(cost_all)), 3),
        cost_p95=round(float(np.percentile(cost_all, 95)), 3),
        dyn_feas_p50=round(float(np.median(feas_all)), 5),
        timed_solves=timed, timed_seconds=round(t_g, 3),
        solves_per_s=round(timed / t_g, 1) if t_g > 0 else None)
    r.update(_iter_stats(infos))
    return r


def mhpc_chain(qr, cfg, model, device, dtype, chain):
    """(chain_steps, propagators) of `chain` receding-horizon plans
    dt_mpc apart from qr's time (advancing qr): the warm-start maps and
    plant steps between consecutive plans."""
    chain_steps, host_plans = [], []
    for i in range(max(chain, 1)):
        plan, pen, x0, Xb, Ub, plan_np = build_mhpc_case(qr, cfg, device,
                                                         dtype)
        chain_steps.append([plan, pen, x0, Xb, Ub, None])
        host_plans.append(plan_np)
        if i + 1 < max(chain, 1):
            qr.step(cfg.dt_mpc)
    propagators = []
    for i in range(1, len(host_plans)):
        chain_steps[i][5] = warm_start_indices(
            host_plans[i - 1].knot, (i - 1) * cfg.dt_mpc,
            host_plans[i].knot, i * cfg.dt_mpc)
        propagators.append(make_propagator(model, cfg.BG_alpha,
                                           host_plans[i - 1], cfg.dt_mpc))
    return [tuple(c) for c in chain_steps], propagators


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--total", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--config", choices=["mhpc", "hkd"], default="mhpc")
    # each scenario = a warm-started MPC chain of this many re-solves;
    # 1 = one-shot cold starts
    ap.add_argument("--chain", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(REPO, "SWEEP_torch.json"))
    ap.add_argument("--ref-dir", default=None)
    ap.add_argument("--settings-dir", default=None)
    ap.add_argument("--arcdog-urdf", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.arcdog_urdf is not None and args.config != "mhpc":
        ap.error("--arcdog-urdf belongs to --config mhpc")
    check_device(args.device)
    device = torch.device(args.device)
    dtype = torch.float32
    ref_dir = args.ref_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.out)), "sweep_refs")

    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh = scenario_mesh() if n_dev > 1 else None
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        urdf = synthetic_robot.write_synthetic_quadruped_urdf(tmp)
        models = {dt: wbm.load_model(urdf, device, dt)
                  for dt in (torch.float32, torch.float64)}
    robots = {"mini_cheetah": models}
    if args.arcdog_urdf is not None:
        robots["arcdog"] = arcdog_models(args.arcdog_urdf, device)
    gaits = HKD_GAITS if args.config == "hkd" else MC_GAITS
    data = {}
    for gait in gaits:
        t0 = time.perf_counter()
        path, made = gait_csv(ref_dir, gait, models[torch.float64])
        data[gait] = dict(csv=path, generated=made,
                          seconds=round(time.perf_counter() - t0, 3))
    result = dict(config=args.config, devices=n_dev,
                  device=device_name(device),
                  total_requested=args.total, chunk=args.chunk,
                  chain=args.chain,
                  robot="synthetic quadruped (models/synthetic_robot.py)",
                  gaits=data, cases={})

    def per_case(n_cases, i):
        # the remainder spread so that the cases sum to the total
        base, rem = divmod(args.total, n_cases)
        return base + (1 if i < rem else 0)

    if args.config == "hkd":
        opts, result["settings"] = hkd_settings(args.settings_dir)
        solve_b = make_batched_solver(hp.make_hkd_fns(), opts, mesh=mesh,
                                      trim_output=True)
        seen_bs = set()
        for ci, gait in enumerate(HKD_GAITS):
            fns, plan, pen, x0, Xb, Ub = build_hkd_case(
                data[gait]["csv"], device, dtype)
            r = run_case(solve_b, mesh, plan, pen, x0, Xb, Ub,
                         per_case(len(HKD_GAITS), ci), args.chunk, rng,
                         dtype, seen_bs=seen_bs)
            result["cases"][f"mini_cheetah/{gait}"] = r
            print(f"mini_cheetah/{gait:10s} {r}", flush=True)
    else:
        cfg, opts, result["settings"] = mhpc_settings(args.settings_dir)
        cases = [("mini_cheetah", g) for g in MC_GAITS]
        if args.arcdog_urdf is None:
            result["skipped"] = {
                f"arcdog/{g}": "needs the arcdog URDF: pass --arcdog-urdf "
                "PATH" for g in ARCDOG_GAITS}
        else:
            result["arcdog_urdf"] = os.path.abspath(args.arcdog_urdf)
            result["arcdog_gaits"] = {}
            cases += [("arcdog", g) for g in ARCDOG_GAITS]
        solvers, seen = {}, {}          # one solver per robot
        for ci, (robot, gait) in enumerate(cases):
            model = robots[robot][torch.float32]
            if robot == "arcdog":
                t0 = time.perf_counter()
                qr = arcdog_quad_ref(gait, MHPC_WINDOW,
                                     robots[robot][torch.float64])
                result["arcdog_gaits"][gait] = dict(
                    generated="in memory",
                    seconds=round(time.perf_counter() - t0, 3))
            else:
                qr = quad_ref(data[gait]["csv"], MHPC_WINDOW)
            if robot not in solvers:
                solvers[robot] = make_batched_solver(
                    mp.make_mhpc_fns_segmented(cfg, model), opts, mesh=mesh,
                    **MHPC_KW)
            chain_steps, propagators = mhpc_chain(qr, cfg, model, device,
                                                  dtype, args.chain)
            r = run_case_chain(solvers[robot], mesh, chain_steps,
                               per_case(len(cases), ci), args.chunk, rng,
                               dtype, propagators,
                               seen_bs=seen.setdefault(robot, set()))
            result["cases"][f"{robot}/{gait}"] = r
            print(f"{robot}/{gait:10s} {r}", flush=True)

    cases = result["cases"].values()
    timed = sum(c.get("timed_solves", 0) for c in cases)
    secs = sum(c.get("timed_seconds", 0.0) for c in cases)
    n_solves = sum(c.get("n_solves", c.get("n", 0)) for c in cases)
    result["total_solves"] = n_solves
    # total timed solves over total timed seconds, not a mean of rates
    result["aggregate_solves_per_s"] = round(timed / secs, 1) \
        if secs > 0 else None
    result["overall_success_rate"] = round(
        sum(c["n_success"] for c in cases) / max(n_solves, 1), 4)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(f"TOTAL {n_solves} solves -> {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()

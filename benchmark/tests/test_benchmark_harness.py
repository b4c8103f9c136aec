"""The benchmark's harness on the CPU: the contract of BENCHMARK.json and
its files, discovery by name, the arithmetic of the metrics, the import
rule, the exit without a card, and the reference against the port's
plain path."""
import ast
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, roofline, tracing

ROOT = harness.HERE.parent
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(rel):
    return harness.load_module(harness.HERE / rel,
                               "t_" + rel.replace("/", "_").replace(".", "_"))


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


# ---------------- BENCHMARK.json and its files ----------------------------
def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in BENCH["end_to_end"]
                   + BENCH["per_layer"])) == len(BENCH["end_to_end"]
                                                 + BENCH["per_layer"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert os.path.getsize(ROOT / "BENCHMARK.json") <= 64 * 1024


def test_configs_and_workloads_are_files_that_exist():
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    for c in cfgs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and c["file"].startswith("benchmark/")
        assert line_ok(c["why"])
        d = harness.load_json(ROOT / c["file"])
        assert d["name"] == c["name"] and d["source"] == c["source"]
        assert d["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert (harness.HERE / "problems" / f"{d['problem']}.py").exists()
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line_ok(w["why"])
        wl = harness.load_json(harness.HERE / "workloads" / f"{w['name']}.json")
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert w["config"] in cfgs
        assert (harness.HERE / "traffic" / f"{wl['driver']}.py").exists()
        assert wl["check"]["limits"]
        used.add(w["config"])
    assert used == set(cfgs)


def test_metrics_have_readers_and_every_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and line_ok(m["layer"])
        layers.add(m["layer"])
        mod = load(f"metrics/{m['name']}.py")
        assert callable(mod.read) and isinstance(mod.WRAPPERS, tuple)
        assert mod.read({}) is None     # nothing to read: nothing returned
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        cell = harness.Cell(ROOT, w["name"])
        got = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer()
        for m in cell.per_layer():
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])
    perf = (ROOT / "PERF.md").read_text()
    assert all(layer in perf for layer in layers)


def test_harness_finds_added_files_by_name(tmp_path):
    """A new configuration, cell, traffic driver and per-layer metric
    are files plus entries, with no edit to a harness file."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "benchmark"
    cfg = harness.load_json(b / "configs" / "hkd.json")
    cfg["name"] = "hkd-extra"
    (b / "configs" / "hkd-extra.json").write_text(json.dumps(cfg))
    (b / "traffic" / "extra_loop.py").write_text(
        "def run(ctx):\n    return 'extra'\n")
    (b / "metrics" / "extra.count.py").write_text(
        "WRAPPERS = ()\n\n\ndef read(rec):\n    return rec.get('n')\n")
    (b / "workloads" / "extra-cell.json").write_text(json.dumps(dict(
        name="extra-cell", config="hkd-extra", chips=1, traffic="extra.b1",
        driver="extra_loop", why="a test cell", params={},
        check=dict(limits=dict(cost_gap=1.0)))))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="hkd-extra", source=cfg["source"],
                                 file="benchmark/configs/hkd-extra.json",
                                 reduced=[], why="a test config"))
    bench["workloads"].append(dict(name="extra-cell", config="hkd-extra",
                                   traffic="extra.b1", chips=1,
                                   why="a test cell"))
    bench["end_to_end"][0]["workloads"].append("extra-cell")
    bench["per_layer"].append(dict(
        name="extra.count", unit="count", better="lower",
        source="program_counter", layer="batched solve",
        moves=bench["end_to_end"][0]["name"], workloads=["extra-cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(tmp_path, "extra-cell")
    assert cell.driver.run(None) == "extra"
    assert cell.cfg["name"] == "hkd-extra"
    assert cell.problem.__file__.startswith(str(b))
    readers = cell.readers()
    assert list(readers) == ["extra.count"]
    assert readers["extra.count"].read({"n": 3}) == 3


# ---------------- arithmetic ----------------------------------------------
def test_rate_and_percentiles_over_a_window_with_one_stall():
    batched = load("traffic/batched.py")
    replan = load("traffic/replan.py")
    B = 4
    ok = np.array([True, True, False, True])
    cost = np.array([1.0, np.nan, 2.0, 3.0])
    answers = [(i, cost.copy(), ok.copy()) for i in range(10)]
    # scenario 1 has a non-finite cost and scenario 2 failed: 2 of 4 a solve
    assert batched.solved(answers) == 20
    # 99 updates of 10 ms and one stall of 1,000 ms: the stall is one of
    # the 100 samples (the median holds, the p95 holds, the p100 is it)
    samples = [10.0] * 99 + [1000.0]
    got = replan.latency(samples)
    assert got == dict(replan_ms_p50=10.0, replan_ms_p95=10.0)
    assert replan.percentile(samples, 100) == 1000.0
    # with 6 stalls in 100 the p95 is a stall; a failed update is infinite
    samples = [10.0] * 94 + [1000.0] * 5 + [math.inf]
    got = replan.latency(samples)
    assert got["replan_ms_p95"] == 1000.0 and got["replan_ms_p50"] == 10.0
    assert replan.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert statistics.median([1.0, math.inf]) == math.inf
    assert B * len(answers) - batched.solved(answers) == 20


def test_second_largest_gap_holds_one_outlier_and_not_two():
    from benchmark import check
    X_r = [np.ones(3)] * 4
    K_r = [np.ones(2)] * 4
    near = [np.ones(3) * (1 + 1e-6)] * 4
    one = near[:3] + [np.ones(3) * 1.1]
    two = near[:2] + [np.ones(3) * 1.1] * 2
    args = ([1.0] * 4, [True] * 4, [1.0] * 4, [True] * 4)
    got = check.batched_numbers(*args, one, X_r, K_r, K_r, range(4))
    assert got["traj_gap"] == pytest.approx(0.1)
    assert got["traj_gap_2nd"] == pytest.approx(1e-6)
    got = check.batched_numbers(*args, two, X_r, K_r, K_r, range(4))
    assert got["traj_gap_2nd"] == pytest.approx(0.1)
    # a scenario the program failed reads infinite; one left is its own
    assert check.second_largest([math.inf, math.inf, 0.0]) == math.inf
    assert check.second_largest([2e-5]) == 2e-5


def test_sweep_flops_and_nbytes_on_a_known_shape():
    Bsz, N, xs, us = 2, 3, 2, 1
    f = torch.zeros
    ins = (f(Bsz, N, xs, xs), f(Bsz, N, xs, us), f(Bsz, N, xs),
           f(Bsz, N, us), f(Bsz, N, xs, xs), f(Bsz, N, us, us),
           f(Bsz, N, us, xs), f(Bsz, xs), f(Bsz, xs, xs),
           f(Bsz, N + 1, xs), torch.tensor([0, 1, 0], dtype=torch.int32),
           f(Bsz))
    # per dynamics step: 2*2*3 + 4 + 3*2 + 8 + 2*1*4 + 1*1*2 + 1/6 + 3*1
    # + 2*1 = 45 + 1/6 operations (an FMA counted once), transform step
    # 2*8 + 2*4 = 24; doubled for the FMAs
    dyn = 12 + 4 + 6 + 8 + 8 + 2 + 1 / 6 + 3 + 2
    want = 2.0 * Bsz * (2 * dyn + 1 * 24)
    assert roofline.sweep_flops(ins) == pytest.approx(want)
    # every f32 input read once: 4 bytes a number; w is int32
    n = sum(t.numel() for t in ins)
    assert roofline.nbytes(ins, ()) == 4 * n
    assert roofline.nbytes(ins[:1], (f(5, dtype=torch.float64),)) == \
        4 * Bsz * N * xs * xs + 8 * 5
    ms, which = roofline.bound(3.35e9, 0.0)
    assert which == "bytes" and ms == pytest.approx(1.0)
    ms, which = roofline.bound(0, 67e9)
    assert which == "operations" and ms == pytest.approx(1.0)


def test_profile_reduction_busy_union_markers_and_gaps():
    M = "marker_kernel"
    dev = [(M, 0.0, 1.0),                    # the lone marker first
           ("a", 10.0, 20.0), (M, 21.0, 22.0), ("k1", 22.0, 30.0),
           ("Memcpy HtoD", 30.0, 31.0), (M, 40.0, 41.0),
           ("b", 25.0, 35.0),                # overlaps k1 (another stream)
           ("c", 100.0, 110.0)]
    out = tracing.reduce(dev, wall_s=1e-4, n_units=1,
                         marked=[("sweep", (1, 0.0, 1))])
    # union: [10, 20] + [22, 35] + [100, 110] = 10 + 13 + 10 us
    assert out["busy_s"] == pytest.approx(33e-6)
    assert out["launches"] == 4          # a, k1, b, c (no copies, markers)
    # the marked call spans k1, the copy and b: 8 + 1 + 10 us
    assert out["marks"] == [("sweep", (1, 0.0, 1), pytest.approx(0.019))]
    gaps = out["breakdown"]["idle_gaps"]
    assert gaps[0][1] == pytest.approx(65e-6) and "before c" in gaps[0][0]
    assert tracing.reduce(dev, 1e-4, 1, marked=[]) ["marks"] == []


# ---------------- the import rule and the exit without a card -------------
def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_sources_import_neither_jax_nor_the_jax_package():
    files = [p for p in harness.HERE.rglob("*.py")
             if "__pycache__" not in p.parts]
    assert files
    for p in files:
        for mod in _imports(p):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (p, mod)
            if "reference" in p.relative_to(harness.HERE).parts:
                # the reference takes nothing of the program
                assert mod.split(".")[0] != "cafempc_tpu_torch", (p, mod)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cafempc_tpu_torch_like", sys)
    assert "cafempc_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cafempc_tpu.solver", sys)
    assert harness.forbidden_modules() == ["cafempc_tpu.solver"]


def test_a_run_loads_no_jax_module():
    """A whole run of a small cell on the CPU in a fresh interpreter:
    afterwards no module with a forbidden top-level name is loaded."""
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "t = time.perf_counter()\n"
        "from benchmark import harness\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "def ov(c):\n"
        "    c.wl['params'].update(x_sigma=0.01, warmup=0, gait_seconds=2.0)\n"
        "    c.wl['check']['updates'] = 1\n"
        "    c.cfg['settings'].update(plan_duration=0.3, n_steps_max=40)\n"
        "cell = harness.Cell(harness.HERE.parent, 'hkd-replan-b1-f64', ov)\n"
        "r = harness.run_cell(cell, 3, 0.5, False, t, device='cpu',\n"
        "                     log=lambda m: None)\n"
        "print(json.dumps(dict(correct=r['correct'],\n"
        "                      bad=harness.forbidden_modules())))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == dict(correct=True, bad=[])


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "hkd-b2048-f32",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "metrics" not in out.stderr and "no result" in out.stderr


# ---------------- the reference against the port's plain path -------------
def test_reference_is_the_ports_plain_path_at_a_tiny_size():
    """The frozen copy solves the hkd plan as the port's plain path does
    (f64, CPU, every kernel as its plain twin), and the MHPC WB and SRB
    partials agree on the same knots."""
    from cafempc_tpu_torch.parallel.mesh import make_batched_solver
    from benchmark.problems import hkd, mhpc
    torch.set_num_threads(2)
    cfg = harness.load_json(harness.HERE / "configs" / "hkd.json")
    cfg["settings"].update(plan_duration=0.3, n_steps_max=40)
    gait = hkd.make_gait(cfg, 2.0)
    f64 = torch.float64
    p = hkd.program_batched(cfg, gait, torch.device("cpu"), f64, 3)
    x0 = torch.as_tensor(hkd.nominal_x0(cfg, gait))[None] \
        + 0.01 * torch.randn(3, 24, generator=torch.Generator().manual_seed(1),
                             dtype=f64)
    solve = make_batched_solver(p["fns"], p["opts"], plain_ops=True,
                                **p["solver_kw"])
    res = solve(p["plan"], p["pen"], x0, p["Xbar0"], p["Ubar0"])
    cost, ok, X, K = hkd.reference_batched(cfg, gait, "cpu", f64, x0)
    np.testing.assert_allclose(cost, res.cost.numpy(), rtol=1e-12)
    assert ok.tolist() == res.success.tolist()
    np.testing.assert_allclose(X, res.Xbar.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(K, res.K.numpy(), rtol=0, atol=1e-8)

    from benchmark.reference.plain.problems import mhpc_problem as ref_mp
    from cafempc_tpu_torch.problems import mhpc_problem as mp
    mcfg = harness.load_json(harness.HERE / "configs" / "mhpc.json")
    models = mhpc.make_models()
    try:
        g = mhpc.make_gait(mcfg, 2.0)
        pp = mhpc.program_batched(mcfg, g, torch.device("cpu"), f64, 1,
                                  models)
        ref_fns = ref_mp.make_mhpc_fns_segmented(
            ref_mp.MHPCConfig(**mcfg["settings"]),
            models.reference("cpu", f64))
        sd = pp["plan"].step
        X = pp["Xbar0"][:, :6] + 0.01
        U = torch.full((1, 6, mp.US), 0.1, dtype=f64)
        sl = type(sd)(*[t[:6] for t in sd])
        for name in ("dyn", "dyn_partials", "run_cost_partials"):
            args = (X, U, sl) if name == "dyn" else (
                (X, U, sl) if name == "dyn_partials"
                else (X, U, torch.zeros(1, 6, mp.YS, dtype=f64), sl))
            got = getattr(pp["fns"].fns[0], name)(*args)
            want = getattr(ref_fns.fns[0], name)(*args)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                           atol=1e-12)
    finally:
        models.close()

"""One run of one cell of the benchmark of `cafempc_tpu_torch`.

Everything is found by name, so that a cell, a configuration, a traffic
driver, a problem or a per-layer metric is added by adding files:

  BENCHMARK.json                    the cells, metrics and bounds
  benchmark/workloads/<cell>.json   the cell's driver, parameters, check
  benchmark/configs/<config>.json   the configuration (its `file` entry)
  benchmark/problems/<problem>.py   builds both sides of one problem kind
  benchmark/traffic/<driver>.py     the loop of one traffic kind
  benchmark/metrics/<metric>.py     reads one per-layer metric

A run makes its inputs from the seed, warms up, measures for `seconds`,
reads the peak device memory, frees the program's state, and then holds
the program's answers to the plain reference (`benchmark/reference/`),
each number beside its limit.  `--trace 1` installs the instruments that
the cell's per-layer metrics declare and reports those metrics instead of
the end-to-end ones.
"""
import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
# module top-level names a run may never load (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "cafempc_tpu")
# the port's switches that pick another path than the configuration's
PORT_SWITCHES = ("CAFEMPC_WB_CF", "CAFEMPC_WB_AD_PARTIALS",
                 "CAFEMPC_HKD_AD_PARTIALS")


class NoDevice(RuntimeError):
    pass


def load_module(path, name):
    """A module from a file, whatever its file name (metric files carry
    dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Cell:
    """A cell's entries, files and modules, found by its name."""

    def __init__(self, root, name, overrides=None):
        root = Path(root)
        self.bench = load_json(root / "BENCHMARK.json")
        entry = [w for w in self.bench["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        self.name = name
        # the benchmark's directory in this checkout (the first of `paths`)
        self.dir = here = root / self.bench["paths"][0]
        self.wl = load_json(here / "workloads" / f"{name}.json")
        if self.wl["traffic"] != self.entry["traffic"] \
                or self.wl["config"] != self.entry["config"]:
            raise ValueError(f"workloads/{name}.json disagrees with "
                             "BENCHMARK.json on its traffic or config")
        cfg_entry = [c for c in self.bench["configs"]
                     if c["name"] == self.entry["config"]][0]
        self.cfg = load_json(root / cfg_entry["file"])
        if overrides:
            overrides(self)
        self.driver = load_module(here / "traffic" / f"{self.wl['driver']}.py",
                                  f"benchmark_traffic_{self.wl['driver']}")
        self.problem = load_module(
            here / "problems" / f"{self.cfg['problem']}.py",
            f"benchmark_problem_{self.cfg['problem']}")

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def readers(self):
        return {m["name"]: load_module(self.dir / "metrics" / f"{m['name']}.py",
                                       "benchmark_metric_"
                                       + m["name"].replace(".", "_"))
                for m in self.per_layer()}


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else "not read (no nvidia-smi)"


def pin_environment():
    """The configurations' path: none of the port's switches set, TF32
    off (every configuration states its float32 without it)."""
    import torch
    for k in PORT_SWITCHES:
        os.environ.pop(k, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(cell, seed, seconds, trace, t_start, device="cuda",
             control=False, fault=False, log=print):
    """One run; returns the result dict (the last line's object), with
    every number of the program, of the control (`control`) and of a
    planted fault (`fault`, for a driver that plants one) added for the
    readings."""
    import torch

    from benchmark import check, roofline
    from benchmark.tracing import Trace
    dev = torch.device(device)
    chips = cell.entry["chips"]
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < chips):
        raise NoDevice(f"the cell needs {chips} CUDA device(s); "
                       f"torch.cuda.is_available() is "
                       f"{torch.cuda.is_available()}")
    pin_environment()
    readers = cell.readers() if trace else {}
    wrappers = set()
    for r in readers.values():
        wrappers.update(r.WRAPPERS)
    ctx = types.SimpleNamespace(
        cfg=cell.cfg, params=cell.wl["params"], check=cell.wl["check"],
        device=dev,
        problem=cell.problem, seed=int(seed) % (2 ** 63), seconds=seconds,
        trace=Trace() if trace else None, wrappers=wrappers,
        t_start=t_start)
    if dev.type == "cuda":
        log(f"card: {card_line()}; roofline peaks: {roofline.PEAK_NOTE}")
        torch.cuda.reset_peak_memory_stats(dev)
    out = cell.driver.run(ctx)
    mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
           else 0)
    metrics = {}
    if not trace:
        # a metric `<name>.<variant>` reports the driver's `<name>`
        vals = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": finite(vals[m["name"].split(".")[0]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end()}
    else:
        rec = out["record"]
        for m in cell.per_layer():
            v = readers[m["name"]].read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the reference runs after the peak is read and the program is freed
    models = out["models"]
    if models is not None:
        models.drop_port()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = cell.driver.reference(ctx, out, torch.float64)
    nums = cell.driver.numbers(out, ref)
    checks, ok = check.verdict(nums, cell.wl["check"]["limits"])
    result = dict(correct=bool(ok), attempted=out["attempted"],
                  failed=out["failed"], metrics=metrics,
                  device=dict(platform="gpu" if dev.type == "cuda" else "cpu",
                              kind=(torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu"),
                              count=chips, memory_peak_bytes=int(mem)))
    if trace:
        prof = out["record"].get("profile")
        if prof:
            result["device"].update(busy_s=prof["busy_s"],
                                    window_s=prof["window_s"])
            result["breakdown"] = prof["breakdown"]
            log(f"trace: {prof['n_units']} units profiled, "
                f"{prof['marks_seen']} of {prof['marks_wanted']} marked "
                "calls paired")
    # the readings a limit is set from: the control, and a planted fault,
    # each put in the program's place (benchmark/readings.py)
    sides = {}
    if control:
        sides["control"] = cell.driver.control(ctx, out)
    if fault and hasattr(cell.driver, "fault"):
        sides["fault"] = cell.driver.fault(ctx, out, ref)
    for k, side in sides.items():
        result[f"{k}_numbers"] = cell.driver.numbers(out, ref, side=side)
    if sides:
        result["numbers"] = nums
    result["compared"] = nums["compared"]
    # last: each number compared beside its limit (JSON has no infinity)
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"])
                            else str(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    if models is not None:
        models.close()
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    root = HERE.parent
    log = (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = Cell(root, args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          t_start, log=log)
    except NoDevice as e:
        log(f"benchmark: {e}; no result")
        return 3
    bad = forbidden_modules()
    if bad:
        log(f"benchmark: the run loaded {', '.join(bad)}; no result")
        return 4
    log(f"answers compared: {result['compared']}")
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0

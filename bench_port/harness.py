"""The benchmark's engine: it finds a cell's files by the names in
BENCHMARK.json, runs the cell once and builds the result line.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
Everything else is found by name, so a later change adds files and
entries and edits none:

* `configs/<config>.json` (the configuration's `file`): the model, loss,
  data and numerics, as the cell runs them;
* `traffic/<traffic>.json`: the mix's parameters; its `kind` names the
  generator, `drivers/<kind>.py`, that builds the inputs from the seed,
  warms the program up, runs the window through the program's own entry
  points and hands the reference what it needs;
* `limits/<workload>.json`: the limit of each number the correctness
  check compares;
* `metrics/<metric>.py`: one reader per metric, `read(cell)` -> a number,
  or None when it finds nothing to read (the metric is then left out).

A driver module has four functions: `setup(cell)` -> state (inputs made,
program built, every shape warmed), `window(cell, state)` (the measured
work; it sets `cell.window_s` and fills `cell.work`), `release(cell,
state)` -> what the check keeps (the program's outputs, host copies),
after which the program's state is freed, and `check(cell, kept)` ->
{name: reading}, the reference's comparison.
"""

import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names a run must not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "disvae_tpu")
# the longest traced window: the profiler's stop and the reading of its
# events take seconds per second of a busy window, and the whole run has
# to end within its time
TRACED_SECONDS = 15.0


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules=None):
    """Names in `modules` (sys.modules) whose whole top-level name is one
    of FORBIDDEN: `disvae_tpu_torch` is not `disvae_tpu`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def process_seconds():
    """Seconds since this process started (Linux /proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def _applies(entry, workload, reported):
    """Whether a metric entry is read in `workload`: its `workloads` list
    names it, or it has none and `reported` says so."""
    if "workloads" in entry:
        return workload in entry["workloads"]
    return reported


def cell_metrics(bench, workload, trace):
    """The metric entries a run of `workload` reports: its end-to-end
    metrics with trace 0, its per-layer metrics with trace 1."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, True)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if _applies(m, workload, m["moves"] in names)]


class Cell:
    """One run of one cell: its entries and files, the run's arguments,
    and what the run measured."""

    def __init__(self, bench, workload, seed, seconds, trace, device,
                 root=ROOT, control=False):
        self.bench, self.root = bench, root
        bench_dir = os.path.join(root, bench["paths"][0])
        self.dir = bench_dir
        try:
            self.entry = next(w for w in bench["workloads"]
                              if w["name"] == workload)
        except StopIteration:
            raise ValueError("no workload {!r} in BENCHMARK.json".format(
                workload)) from None
        self.name = workload
        conf = next(c for c in bench["configs"]
                    if c["name"] == self.entry["config"])
        self.config = load_json(os.path.join(root, conf["file"]))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bench_dir, "limits",
                                             workload + ".json"))
        self.seed, self.trace = int(seed), trace
        self.seconds = min(float(seconds), TRACED_SECONDS) if trace \
            else float(seconds)
        self.device = device
        # the program's lower-precision path in place of its own (the
        # correctness check's control)
        self.control = control
        self.tmp = tempfile.mkdtemp(prefix="bench_port_")
        self.work = {"attempted": 0, "failed": 0}
        self.timings = []
        self.window_s = self.setup_s = self.summary = None

    def driver(self):
        return load_module(os.path.join(self.dir, "drivers",
                                        self.traffic["kind"] + ".py"),
                           "bench_driver_" + self.traffic["kind"])

    def reader(self, metric):
        return load_module(os.path.join(self.dir, "metrics", metric + ".py"),
                           "bench_metric_" + metric.replace(".", "_"))

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench, workload, seed, seconds, trace, device, root=ROOT,
             control=False, started=None, extra=None):
    """Run `workload` once on `device`. Returns (result, checks): the
    result line's dict without its `checks` key, and {name: {"value",
    "limit"}} of every number compared. `extra(cell, driver, kept,
    readings)`, when given, is called after the check (calibrate.py's
    further readings)."""
    import torch
    from devtrace import Profile, summarize

    t0 = time.perf_counter() - (started or 0.0)
    cell = Cell(bench, workload, seed, seconds, trace, device, root,
                control)
    try:
        driver = cell.driver()
        state = driver.setup(cell)
        _sync(device)
        cell.setup_s = time.perf_counter() - t0
        if trace:
            with Profile(device) as prof:
                driver.window(cell, state)
            cell.summary = summarize(prof.events)
            del prof
        else:
            driver.window(cell, state)
        _sync(device)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        kept = driver.release(cell, state)
        del state
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        metrics = {}
        for m in cell_metrics(bench, workload, trace):
            value = cell.reader(m["name"]).read(cell)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        readings = driver.check(cell, kept)
        if extra is not None:
            extra(cell, driver, kept, readings)
    finally:
        cell.close()
    checks = {k: {"value": float(readings.get(k, math.nan)),
                  "limit": float(limit)}
              for k, limit in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": int(cell.entry.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": int(cell.work["attempted"]),
              "failed": int(cell.work["failed"]),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = cell.summary["busy_s"]
        dev["window_s"] = cell.window_s
        result["breakdown"] = {"device_ops": cell.summary["device_ops"],
                               "idle_gaps": cell.summary["idle_gaps"]}
    return result, checks

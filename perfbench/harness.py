"""The benchmark's harness.  It finds everything by the names in
``BENCHMARK.json``:

- a cell (``workloads``) names its configuration and traffic;
- a configuration's ``file`` holds its sizes and training values;
- a traffic mix is ``perfbench/traffic/<traffic>.json``, data whose
  ``driver`` names the module of ``perfbench/drivers/`` that runs it
  (``drivers/__init__.py`` gives the interface);
- a cell's limits are ``perfbench/limits/<cell>.json`` (``check.py``);
- a metric is read by ``perfbench/metrics/<metric>.py``'s ``read(record)``,
  which returns its number, or None where the run has nothing to read.

So a later cell, mix, kind of traffic or metric is new files and new
entries, and no edit.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from perfbench import check, trace


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


class Bench:
    """``BENCHMARK.json`` of a checkout and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.root / "perfbench" / "traffic" / f"{name}.json")

    def driver(self, name: str):
        """The module ``perfbench/drivers/<name>.py`` of this checkout."""
        return self._module("drivers", name)

    def limits(self, cell: str) -> dict:
        return load_json(self.root / "perfbench" / "limits" / f"{cell}.json")

    def metrics(self, cell: str, trace_on: bool) -> list:
        """The cell's metric entries: its end-to-end ones, or with a trace
        its per-layer ones."""
        kind = "per_layer" if trace_on else "end_to_end"
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """``read`` of ``metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def _module(self, folder: str, name: str):
        path = self.root / "perfbench" / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def gpu_sample() -> str:
    """The card's name, power limit, SM clock and power draw."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(root: Path, name: str, seed: int, seconds: float,
             trace_on: bool, device="cuda", t_start=None,
             log=sys.stderr) -> dict:
    """One run of a cell: the driver's set-up, its window (with a trace:
    spans in it and a profiled period after it), the check; the result
    line."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root)
    w = bench.cell(name)
    cfg, tr = bench.config(w["config"]), bench.traffic(w["traffic"])
    limits = bench.limits(name)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if trace_on and not cuda:
        raise RuntimeError("a traced run profiles the card")
    run = bench.driver(tr["driver"]).setup(
        cfg, tr, seed, device, lambda msg: print(msg, file=log))
    if cuda:
        print(f"card: {gpu_sample()} (before the window)", file=log)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    record = {"setup_s": None}
    win = run.window(seconds, record if trace_on else None)
    record["setup_s"] = win["t0"] - t_start
    record["window"] = win
    print(f"window: {win['steps']} steps in {win['seconds']:.6f} s; "
          f"set-up {record['setup_s']:.6f} s", file=log)
    print(f"events over the window: {json.dumps(win['events'])}", file=log)
    run.report(log)
    peak = 0
    if cuda:
        win_peak = torch.cuda.max_memory_allocated(device)
        peak = max(setup_peak, win_peak)
        print(f"peak device memory: window {win_peak} B, run {peak} B",
              file=log)
        print(f"card: {gpu_sample()} (after the window)", file=log)
    run.free()

    if trace_on:
        record.update(trace.reduce_events(record.pop("_prof")))
        record["work"] = run.work(record, device)
    values = run.readings(device)
    correct, shown = check.judge(values, limits)
    correct = correct and win["steps"] > 0
    print(f"check: readings {json.dumps(values)}", file=log)

    metrics = {}
    for m in bench.metrics(name, trace_on):
        v = bench.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": win["steps"],
              "failed": 0, "metrics": metrics, "device": dev}
    if trace_on:
        dev.update(busy_s=record["busy_s"], window_s=record["traced_s"])
        ops = sorted(record["device_s"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {"device_ops": [[n, s] for n, s in ops[:10]],
                               "idle_gaps": record["idle_gaps"]}
    result["compared"] = shown
    return result

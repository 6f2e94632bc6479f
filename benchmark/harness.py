"""One run of one cell: everything is found by name.

`BENCHMARK.json` names the cell's configuration and traffic mix and the
metrics it reports. The configuration is `configs/<config>.json`, the mix
`traffic/<mix>.json` (whose `"driver"` names the general driver in
`drivers/`), the limits of the compared numbers `limits/<cell>.json`, and
each metric a reader `metrics/<metric>.py`. A later change adds a
configuration, a mix, a cell or a metric by adding those files and entries.

A run: set-up (timed from the process's start to the first timed unit of
work), the window, and with `trace` a second, profiled stretch; then the
port's state is freed and the cell's `Driver.check` compares what the
window produced with the plain reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import time
from typing import Optional

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: seconds of the profiled stretch of a traced run
TRACE_SECONDS = 2.0


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str, bench_dir: str = BENCH_DIR):
    """The module `metrics/<name>.py` (metric names hold dots, so it is
    loaded from its file)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """A cell and everything found by its name."""

    name: str
    bench_dir: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def find_cell(name: str, root: str = ROOT) -> Cell:
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = os.path.join(root, "benchmark")
    return Cell(
        name=name, bench_dir=bench,
        config=_json(os.path.join(root, configs[w["config"]]["file"])),
        traffic=_json(os.path.join(bench, "traffic", f"{w['traffic']}.json")),
        limits=_json(os.path.join(bench, "limits", f"{name}.json")),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, name)])


def make_driver(cell: Cell, seed: int, device, fault: Optional[str] = None):
    module = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    return module.Driver(cell.config, cell.traffic, seed, device, fault=fault)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window: object
    trace: object = None
    traced_window: object = None


def read_metrics(specs: list, run: Run, required: bool) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something; a required one that reads nothing raises."""
    out = {}
    for spec in specs:
        value = load_reader(spec["name"], run.cell.bench_dir).read(run)
        if value is None:
            if required:
                raise RuntimeError(f"end-to-end metric {spec['name']} read "
                                   f"nothing in {run.cell.name}")
            continue
        out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit; a number without a limit, or a limit without its
    number, is not correct."""
    checks = {k: {"value": float(v), "limit": float(limits[k]["limit"])}
              for k, v in numbers.items() if k in limits}
    ok = (set(numbers) == set(limits)
          and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()))
    return ok, checks


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None, root: str = ROOT,
             fault: Optional[str] = None, cell: Optional[Cell] = None
             ) -> dict:
    """One run of cell `name`; returns the result line's object. `cell`
    replaces what the name finds (the tests give small sizes); `fault`
    plants one of the faults that the cell's `Driver` knows in the timed
    path."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = cell or find_cell(name, root)
    driver = make_driver(cell, seed, device, fault)
    driver.setup()
    setup_s = time.perf_counter() - t0
    # benchmark spans only in the traced run, whose end-to-end numbers
    # are not reported
    window = driver.window(seconds, spans=trace)
    dev = torch.device(device)
    run = Run(cell=cell, setup_s=setup_s, window=window)
    if trace:
        from benchmark import trace as trace_mod

        run.traced_window, run.trace = trace_mod.profiled(
            lambda: driver.window(min(TRACE_SECONDS, seconds), spans=True))
    on_card = dev.type == "cuda"
    device_info = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": 1,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if on_card else 0),
    }
    if trace:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    driver.release()
    correct, checks = judge(driver.check(), cell.limits)
    correct = correct and window.failed == 0
    metrics = (read_metrics(cell.per_layer, run, required=False) if trace
               else read_metrics(cell.end_to_end, run, required=True))
    result = {"correct": correct, "attempted": window.units,
              "failed": window.failed, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["setup_phases"] = driver.phases.seconds
    result["checks"] = checks
    return result

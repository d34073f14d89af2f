"""Run one cell once: find its files by name, drive it, read its metrics,
decide ``correct``, and build the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its
``config`` names ``configs/<config>.json``, its ``traffic`` names
``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``;
``cells/<cell>.json`` holds the limits of its comparison.  Each metric of
``BENCHMARK.json`` that applies to the cell is read by
``metrics/<metric>.py``.  Adding a cell or a metric adds files and an
entry, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that no process of the benchmark may hold, by whole top-level name
FORBIDDEN = {"jax", "jaxlib", "flax", "voltools_tpu"}


@dataclass
class Cell:
    """What a driver is given: the cell's name, its data files, the run's
    arguments and the device."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: torch.device

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of this package as a module (names may hold
    dots, so it is loaded from its path)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    key = f"portbench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_cell(name: str, seed: int, seconds: float, trace: bool,
              device: str = "cuda", bench: dict | None = None,
              config_overrides: dict | None = None) -> Cell:
    bench = bench or benchmark()
    entry = workload(bench, name)
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    config.update(config_overrides or {})
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, config=config, traffic=traffic,
                limits=load_json(HERE / "cells" / f"{name}.json")["limits"],
                chips=int(entry["chips"]), seed=int(seed),
                seconds=float(seconds), trace=bool(trace),
                device=torch.device(device))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, started: float, bench: dict | None = None) -> dict:
    """Set up, measure, check; returns the result line (a dict whose last
    key, ``checks``, holds each compared number beside its limit)."""
    bench = bench or benchmark()
    driver = load_module("drivers", cell.traffic["driver"]).Driver(cell)
    driver.setup()
    record = driver.window()
    record["setup_s"] = record["t0"] - started
    if cell.trace:
        driver.trace(record)
    peak = record.get("peak_bytes", 0)
    driver.release()
    t_check = time.perf_counter()
    result = driver.check()
    check_s = time.perf_counter() - t_check
    print(f"portbench: {cell.name} set-up {record['setup_s']:.3f} s, "
          f"window {record['window_s']:.3f} s, check {check_s:.3f} s",
          file=sys.stderr)

    kind = "per_layer" if cell.trace else "end_to_end"
    metrics = {}
    for metric in bench[kind]:
        if not applies(metric, cell.name):
            continue
        value = load_module("metrics", metric["name"]).read(record)
        if value is None:
            if not cell.trace:
                raise RuntimeError(f"metric {metric['name']} read nothing")
            continue
        metrics[metric["name"]] = {"value": float(value),
                                   "unit": metric["unit"]}
    checks = {key: {"value": float(value), "limit": float(cell.limits[key])}
              for key, value in result["compared"].items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if cell.cuda else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.cuda else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": ok and result["answers"] > 0,
            "attempted": int(record["completed"]),
            "failed": int(result["failed"]), "metrics": metrics,
            "device": device}
    if cell.trace:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["wall_s"]
        line["breakdown"] = record["trace"]["breakdown"]
    line["checks"] = checks
    return line

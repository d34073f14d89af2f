"""The program tracer's own numbers on the card: what a cell's program pass
saw, the anchor's error and the tracer's cost.

    python3 tools/trace_report.py cells [--seconds S] [--out D] CELL...
    python3 tools/trace_report.py anchor [--trials N]
    python3 tools/trace_report.py offcost [--parent DIR ...] [--calls N]

``cells`` sets up each benchmark cell, runs its window and its traced
passes (as ``portbench/run.py --trace 1`` does, without the check), then
a program pass: the window once more with the program's tracer on.  It
uses the drivers' public methods only (``setup``, ``window``, ``trace``,
``release``).  It prints one JSON line a cell: the benchmark's per-layer
metrics, what the program's spans give (``span_metrics``), the pass's
coverage (its device intervals' union per call over the queued pass's
busy time per call), its idle plus busy against its wall, its on-cost
(the pass's wall per call over the window's), every attributed idle gap
and each span's device time, us a call; the export goes to
``<out>/trace_<cell>.json`` (default ``trace_exports/``) for Perfetto.
Give it one cell a process, as the benchmark runs them.  The benchmark
itself runs no program pass (PERF.md, open questions).
``anchor``
places a known device sleep on the host clock and prints the errors.
``offcost`` prints the host us a call of ``StaticVolume.affine`` and of
its parts with the tracer off at 32^3 (the device far ahead of the
host), one call of each side in turn with the package of each checkout
``--parent`` imported beside this one (a second ``--parent`` that copies
the first reads what the method gives where nothing changed), and what a
site and a counter cost off, and an event and a bracket on.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def program_pass(driver, trace):
    """The driver's window once more, with the program's tracer on
    (device work included): its record, the export, its idle gaps and the
    counters it moved."""
    before = trace.counts()
    trace.start(device=True)
    try:
        record = driver.window()
    finally:
        trace.stop()
    export = trace.export()
    after = trace.counts()
    return {"calls": record["completed"], "wall_s": record["window_s"],
            "export": export, "idle": trace.idle_gaps(export),
            "counts": {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}}


def span_metrics(prog, trace):
    """What the program's spans give a call of the pass: host us of
    ``resample.upload``, of ``kernel_a`` and of ``wbp.validate`` with
    ``wbp.plan``; device ms of ``wbp.filter``; device ms of the
    ``project.sum`` spans a forward sweep (their parents, one a
    ``project_stack``) and of ``sirt.update`` an iteration; device-idle
    us while a span was open.  A quantity whose spans the pass did not
    record is left out."""
    calls = prog["calls"]
    host, device = {}, {}
    for e in prog["export"]["traceEvents"]:
        if e["ph"] == "X":
            found = host if e["pid"] == trace.HOST else device
            found.setdefault(e["name"], []).append(e)

    def host_us(*names):
        spans = [e for name in names for e in host.get(name, [])]
        return sum(e["dur"] for e in spans) / calls if spans else None

    def device_ms(name):
        return sum(e["dur"] for e in device.get(name, [])) / 1e3

    found = {"upload_host_us": host_us("resample.upload"),
             "wrapper_host_us": host_us("kernel_a"),
             "validate_host_us": host_us("wbp.validate", "wbp.plan"),
             "idle_in_program_us": sum(
                 v for k, v in prog["idle"]["idle_s"].items()
                 if k != trace.OUTSIDE) / calls * 1e6}
    if device.get("wbp.filter"):
        found["filter_ms"] = device_ms("wbp.filter") / calls
    if device.get("project.sum"):
        forwards = {e["args"]["parent"] for e in host["project.sum"]}
        found["stack_sum_ms"] = device_ms("project.sum") / len(forwards)
    if device.get("sirt.update") and host.get("sirt.iteration"):
        found["update_ms"] = (device_ms("sirt.update")
                              / len(host["sirt.iteration"]))
    return {k: v for k, v in found.items() if v is not None}


def cells(args):
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from voltools_tpu_torch.utils import trace
    bench = harness.benchmark()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in args.cells:
        started = time.perf_counter()
        cell = harness.make_cell(name, args.seed, args.seconds, True, "cuda",
                                 bench)
        driver = harness.load_module("drivers",
                                     cell.traffic["driver"]).Driver(cell)
        driver.setup()
        record = driver.window()
        record["setup_s"] = record["t0"] - started
        driver.trace(record)
        tr = record["trace"]
        metrics = {m["name"]: harness.load_module("metrics", m["name"]).read(
            record) for m in bench["per_layer"] if harness.applies(m, name)}
        prog = program_pass(driver, trace)
        idle = prog["idle"]
        calls = prog["calls"]
        window_us = record["window_s"] / record["completed"] * 1e6
        device = {}
        for e in prog["export"]["traceEvents"]:
            if e["ph"] == "X" and e["pid"] == trace.DEVICE:
                found = device.setdefault(e["name"], [0.0, 0])
                found[0] += e["dur"] / calls
                found[1] += 1 / calls
        line = {
            "cell": name, "metrics": metrics,
            "spans": span_metrics(prog, trace),
            "coverage": idle["busy_s"] / calls / (tr["busy_s"] / tr["calls"]),
            "busy_us": idle["busy_s"] / calls * 1e6,
            "queued_busy_us": tr["busy_s"] / tr["calls"] * 1e6,
            "idle_plus_busy_over_wall": (sum(idle["idle_s"].values())
                                         + idle["busy_s"]) / prog["wall_s"],
            "pass_us": prog["wall_s"] / calls * 1e6,
            "window_us": window_us,
            "on_cost": prog["wall_s"] / calls * 1e6 / window_us,
            "idle_us": {k: v / calls * 1e6 for k, v in sorted(
                idle["idle_s"].items(), key=lambda kv: -kv[1])},
            "device_us": device,    # us and intervals a call, by span
            "counts": prog["counts"],
            "device_counters": {k: prog["export"]["otherData"]["counters"][k]
                                for k in ("fast_path_voxels", "overflows",
                                          "window_misses")}}
        (out / f"trace_{name}.json").write_text(json.dumps(prog["export"]))
        print(json.dumps(line), flush=True)
        driver.release()
        del driver, record, tr, prog
        trace.start()       # forgets the pass's spans and events
        trace.stop()


def _sleep_cycles(torch, ms):
    torch.cuda._sleep(10 ** 6)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    torch.cuda.synchronize()
    return int(ms * 10 ** 7 / a.elapsed_time(b))


def _wait(stream):
    """Poll ``stream`` until its work is done: (the start of the last poll
    that found it running, the host clock after the poll that found it
    done): the work ended between the two."""
    last = time.perf_counter_ns()
    while True:
        t = time.perf_counter_ns()
        if stream.query():
            return last, time.perf_counter_ns()
        last = t


def anchor(args):
    sys.path.insert(0, str(ROOT))
    import torch
    from voltools_tpu_torch.utils import trace
    cycles = _sleep_cycles(torch, 2.0)
    stream = torch.cuda.current_stream()
    seen = []
    trace.start(device=True)
    for i in range(args.trials):
        if i % 10 == 0:
            trace.mark()
        time.sleep(0.003)
        with trace.span("sleep", device=True):
            torch.cuda._sleep(cycles)
        seen.append(_wait(stream))
    trace.stop()
    export = trace.export()
    origin = export["otherData"]["origin_ns"]
    work = [e for e in export["traceEvents"]
            if e["ph"] == "X" and e["pid"] == trace.DEVICE]
    # the sleep's end on the host clock against the bracket the host saw
    # it end in: its middle, and how far outside the bracket it falls
    off_middle, outside, half = [], [], []
    for e, (lo, hi) in zip(work, seen):
        end = origin + (e["ts"] + e["dur"]) * 1e3
        off_middle.append(abs(end - (lo + hi) / 2) / 1e3)
        outside.append(max(lo - end, end - hi, 0) / 1e3)
        half.append((hi - lo) / 2e3)
    widths = [w for a in export["otherData"]["anchors"].values()
              for _, w in a]

    def spread(values):
        deciles = statistics.quantiles(values, n=10)
        return {"median": statistics.median(values), "p90": deciles[-1],
                "max": max(values)}

    print(json.dumps({"trials": len(work),
                      "end_off_middle_us": spread(off_middle),
                      "end_outside_bracket_us": spread(outside),
                      "bracket_half_width_us": spread(half),
                      "anchor_width_us": spread(widths),
                      "sleep_ms": spread([e["dur"] / 1e3 for e in work])}),
          flush=True)


def _alias(name, root):
    """The package ``voltools_tpu_torch`` of checkout ``root`` imported as
    ``name`` (its imports are relative), beside this checkout's."""
    import importlib.util
    pkg = Path(root).resolve() / "voltools_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _best_ns(fn, n):
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        fn(n)
        best = min(best, (time.perf_counter() - t0) / n * 1e9)
    return best


def offcost(args):
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import voltools_tpu_torch as vt
    from voltools_tpu_torch.utils import trace
    sides = {"change": vt}
    # the first --parent is what every other side is held against; a
    # second copy of it shows what the method reads where nothing changed
    for i, root in enumerate(args.parent or ()):
        side = "parent" if i == 0 else f"parent_{i + 1}"
        sides[side] = _alias(f"voltools_tpu_torch_{side}", root)
    shape = (32, 32, 32)
    rng = np.random.default_rng(5)
    vol = rng.random(shape).astype(np.float32)
    ms = [vt.utils.transform_matrix(rotation=tuple(rng.uniform(-180, 180, 3)),
                                    rotation_order="sxyz", center=(16,) * 3)
          .astype(np.float32) for _ in range(64)]
    runs = {}
    for name, pkg in sides.items():
        sv = pkg.StaticVolume(vol)
        out = torch.empty(shape, device="cuda")
        for m in ms:
            sv.affine(m, output=out)
        runs[name] = (sv, out)
    torch.cuda.synchronize()
    # one call of each side in turn, each timed alone: both sides meet the
    # same state of the host, and the medians leave out preempted calls
    dev = torch.device("cuda", 0)
    parts = {
        "StaticVolume.affine": lambda pkg, sv, out, m: sv.affine(
            m, output=out),
        "_device_matrices": lambda pkg, sv, out, m: sys.modules[
            pkg.__name__ + ".transforms"]._device_matrices(m, dev),
        "kernel A wrapper": lambda pkg, sv, out, m: sys.modules[
            pkg.__name__ + ".transforms"].affine_resample(
                sv.data, mats, 1, "constant", 0.0, shape, out),
        "route and walk_patch": lambda pkg, sv, out, m: (
            sys.modules[pkg.__name__ + ".transforms"].route(
                m, shape, "linear", "constant", shape),
            sys.modules[pkg.__name__ + ".transforms"].walk_patch(m))}
    mats = torch.as_tensor(ms[0], device=dev)

    def stubbed(pkg, sv, out, m):
        """``_resample``'s own host work: the upload and the kernel
        stubbed out."""
        tr = sys.modules[pkg.__name__ + ".transforms"]
        keep = tr.affine_resample, tr._device_matrices
        tr.affine_resample = lambda *a, **k: out
        tr._device_matrices = lambda *a: mats
        try:
            tr._resample(sv.data, m, "linear", "constant", 0.0, out=out)
        finally:
            tr.affine_resample, tr._device_matrices = keep

    parts["_resample, its upload and kernel stubbed"] = stubbed
    clock = time.perf_counter_ns
    order = list(sides)
    line = {}
    for part, fn in parts.items():
        us = {name: [] for name in sides}
        for i in range(args.calls):
            for name in (order if i % 2 else order[::-1]):
                sv, out = runs[name]
                t0 = clock()
                fn(sides[name], sv, out, ms[i % 64])
                us[name].append((clock() - t0) / 1e3)
            if i % 1000 == 999:
                torch.cuda.synchronize()
        found = {name: statistics.median(v) for name, v in us.items()}
        for side in sides:
            if side == "parent" or "parent" not in sides:
                continue
            diffs = [a - b for a, b in zip(us[side], us["parent"])]
            found[f"{side}_less_parent_us"] = statistics.median(diffs)
            found[f"{side}_quartiles_of_pairs"] = statistics.quantiles(
                diffs, n=4)
        line[part] = found

    def site(n):
        for _ in range(n):
            with trace.span("x"):
                pass

    def counter(n):
        for _ in range(n):
            trace.count("x")

    def made(n):
        stream = torch.cuda.current_stream()
        for _ in range(n):
            torch.cuda.Event(enable_timing=True).record(stream)

    events = [torch.cuda.Event(enable_timing=True) for _ in range(1000)]
    for e in events:
        e.record()

    def recorded(n):
        stream = torch.cuda.current_stream()
        for i in range(n):
            events[i % 1000].record(stream)

    def stream(n):
        for _ in range(n):
            torch.cuda.current_stream(0)

    def old_dispatch(n):
        # the parent's note for last_dispatch(), made on every call
        local, plan, rule, patch = threading.local(), None, "speed", (1, 4, 8)
        why = ("1 matrices a launch, outside the slab kernel's window of "
               "at least 2 (order 1)")
        for _ in range(n):
            kernel = f"walk kernel (affine_resample, warp patch {patch})"
            kernel = f"{kernel} by the {rule} rule: {why}"
            local.info = dict(impl="cuda", variant=plan, rule=rule,
                              reason=f"CUDA {kernel}")

    def new_dispatch(n):
        local, plan, rule, patch, why = (threading.local(), None, "speed",
                                         (1, 4, 8), "x")
        for _ in range(n):
            local.pieces = (True, plan, rule, why, patch)

    line["old_dispatch_ns"] = _best_ns(old_dispatch, 10 ** 5)
    line["new_dispatch_ns"] = _best_ns(new_dispatch, 10 ** 5)
    line["site_off_ns"] = _best_ns(site, 10 ** 6)
    line["count_off_ns"] = _best_ns(counter, 10 ** 6)
    line["event_made_and_recorded_ns"] = _best_ns(made, 2000)
    line["event_recorded_ns"] = _best_ns(recorded, 20000)
    line["current_stream_ns"] = _best_ns(stream, 20000)
    trace.start(device=True)
    line["site_on_ns"] = _best_ns(site, 2000)

    def bracket(n):
        for _ in range(n):
            with trace.device_work(True):
                pass

    line["bracket_on_ns"] = _best_ns(bracket, 400)
    trace.stop()
    print(json.dumps(line), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="what", required=True)
    p = sub.add_parser("cells")
    p.add_argument("cells", nargs="+")
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=3141592653)
    p.add_argument("--out", default="trace_exports")
    p = sub.add_parser("anchor")
    p.add_argument("--trials", type=int, default=50)
    p = sub.add_parser("offcost")
    p.add_argument("--parent", action="append",
                   help="another checkout to compare with (again: one more "
                        "side, held against the first)")
    p.add_argument("--calls", type=int, default=40000)
    args = parser.parse_args(argv)
    {"cells": cells, "anchor": anchor, "offcost": offcost}[args.what](args)


if __name__ == "__main__":
    main()

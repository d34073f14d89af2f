"""What the drivers share: the traced replay, memory peaks, the breakdown
and the comparison with the reference."""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import roofline, timing
from portbench.reference import rel_err


def reset_peak(cell) -> int:
    """The device's peak allocation so far; then start a new peak."""
    if not cell.cuda:
        return 0
    peak = torch.cuda.max_memory_allocated(cell.device)
    torch.cuda.reset_peak_memory_stats(cell.device)
    return peak


def peak(cell) -> int:
    return torch.cuda.max_memory_allocated(cell.device) if cell.cuda else 0


def warm(cell, calls, sleep_ms):
    """Queue ``calls`` behind a sleep once at set-up, so that the traced
    replays find the host's pinned buffers and the device's memory
    already allocated."""
    cycles = sleep_ms * timing.sleep_cycles_per_ms(torch)
    timing.queued_ms(torch, calls, cycles)


def replay(cell, rounds, spans, patches, params, sync_each):
    """Each round of calls: live as the window calls them (with
    ``sync_each`` a synchronize after each), for its wall time; queued
    behind a sleep of ``params['sleep_ms']``, for its device busy time and
    the host spans; then queued once more for each device span name, with
    a CUDA event pair around each of at most ``params['events']`` of its
    launches.  ``patches`` are (module, attribute, span name, device
    spans?, note).  Returns the trace record the metric readers take."""
    sleep_ms = params["sleep_ms"]
    cycles = sleep_ms * timing.sleep_cycles_per_ms(torch)
    wall = busy = 0.0
    n = 0

    def api(call):
        def timed():
            t0 = time.perf_counter()
            call()
            spans.host["api"].append(time.perf_counter() - t0)
        return timed

    with contextlib.ExitStack() as stack:
        for module, attr, name, device, note in patches:
            stack.enter_context(timing.patched(
                torch, module, attr, spans, name, device, note))
        for calls in rounds:
            cell.sync()
            t0 = time.perf_counter()
            for call in calls:
                call()
                if sync_each:
                    cell.sync()
            cell.sync()
            wall += time.perf_counter() - t0
            spans.on_host = True
            busy += timing.queued_ms(torch, [api(c) for c in calls],
                                     cycles)[0] / 1e3
            spans.on_host = False
            for name in dict.fromkeys(p[2] for p in patches if p[3]):
                spans.on_device, spans.budget = name, params["events"]
                timing.queued_ms(torch, calls, cycles)
                spans.on_device = None
            n += len(calls)
    torch.cuda.synchronize()
    return {"calls": n, "wall_s": wall, "busy_s": busy,
            "host_s": {k: list(v) for k, v in spans.host.items()},
            "device_ms": {k: spans.device_ms(k) for k in spans.device}}


def device_total_s(trace, name) -> float:
    """Device seconds of all the launches ``name`` in the busy pass: the
    mean of the timed launches times the launches the pass made."""
    timed = trace["device_ms"].get(name)
    if not timed:
        return 0.0
    return sum(timed) / len(timed) * len(trace["host_s"].get(name, [])) / 1e3


def breakdown(trace, device_parts, rest_label, host_labels):
    """The ``breakdown`` of the result line: ``device_parts`` (label,
    seconds) and the rest of the busy time under ``rest_label``, largest
    first; the idle time (live wall less queued busy) and the host spans
    by what the host was doing, largest first; at most 10 of each."""
    parts = [[label, s] for label, s in device_parts if s > 0]
    rest = trace["busy_s"] - sum(s for _, s in parts)
    if rest > 0:
        parts.append([f"{rest_label} (busy less the spans above)", rest])
    gaps = [["device idle: live wall less queued busy",
             trace["wall_s"] - trace["busy_s"]]]
    gaps += [[f"host in {label}", sum(trace["host_s"].get(key, []))]
             for key, label in host_labels.items()
             if trace["host_s"].get(key)]
    return {"device_ops": sorted(parts, key=lambda p: -p[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda p: -p[1])[:10]}


def compare(cell, pairs):
    """``max_rel_err`` over (answer, reference) pairs, and how many of the
    answers read above the cell's limit: {"compared": ..., "failed": n,
    "answers": n}."""
    limit = cell.limits["max_rel_err"]
    worst, failed, count = 0.0, 0, 0
    for got, want in pairs:
        err = rel_err(got, want)
        worst = max(worst, err) if err == err else float("nan")
        failed += not err <= limit
        count += 1
    return {"compared": {"max_rel_err": worst}, "failed": failed,
            "answers": count}


def resample_least_ms(order, shape, mats, mode, device, inside):
    """The least time of a resample launch through the device matrices
    ``mats`` ((4, 4) or (N, 4, 4)), its inside voxels counted once per
    matrix into the cache ``inside``."""
    counts = []
    for m in mats.cpu().numpy().reshape(-1, 4, 4):
        key = m.tobytes()
        if key not in inside:
            inside[key] = roofline.inside_voxels(shape, m, mode, device)
        counts.append(inside[key])
    return roofline.resample_launch_ms(order, shape, shape, counts)[0]

"""The program pass: replayed calls once more, live, under the port's own
tracer (:mod:`voltools_tpu_torch.utils.trace`), and what its export gives
a call: device ms under each span, host and self time of each span, and
each device-idle instant charged to the span the host was in.

It is no part of a cell's ``--trace 1`` run yet: ``tools/trace_report.py
cells`` runs it over each replaying driver's rounds.  :data:`QUANTITIES`
are what a per-layer metric would read of such a pass.
"""

from __future__ import annotations

import time
from collections import defaultdict

from voltools_tpu_torch.utils import trace as program_trace


def program_pass(cell, rounds, sync_each):
    """The ``rounds`` (lists of calls) once more, live, under the
    program's own tracer (device work included on a CUDA device): each
    round synchronised, in a window of its own (``trace.start`` for the
    first, ``trace.mark`` for each later one), its calls run as the window
    runs them (with ``sync_each`` a synchronize after each), synchronised.
    Returns ``calls``; ``round_s``, the rounds' host wall, each from its
    window's opening to its last synchronize; ``counts``, the counters the
    pass moved; and the export's :func:`summary`."""
    before = program_trace.counts()
    round_s, n = 0.0, 0
    try:
        for i, calls in enumerate(rounds):
            cell.sync()
            if i == 0:
                program_trace.start(device=cell.cuda)
            else:
                program_trace.mark()
            t0 = time.perf_counter()
            for call in calls:
                call()
                if sync_each:
                    cell.sync()
            cell.sync()
            round_s += time.perf_counter() - t0
            n += len(calls)
    finally:
        program_trace.stop()
    after = program_trace.counts()
    return {"calls": n, "round_s": round_s,
            "counts": {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)},
            **summary(program_trace.export())}


def summary(export):
    """What a tracer's export gives: ``windows_s``, each window's wall;
    ``wall_s``, ``busy_s`` and ``idle_s`` of :func:`trace.idle_gaps` (the
    windows' wall, the device intervals' union in them, the idle seconds
    by the span the host was in); ``device_ms``, by span name, the device
    ms of the intervals under it (:func:`device_ms_by_span`); ``host_s``
    and ``self_s``, by span name, its spans' host seconds, and those less
    the part their children cover; ``spans``, how many of each name
    closed, and ``parents``, how many distinct parents they had (no
    parent counts as one)."""
    host = [e for e in export["traceEvents"]
            if e.get("ph") == "X" and e["pid"] == program_trace.HOST]
    covered = defaultdict(float)        # us of each span its children take
    for e in host:
        if e["args"]["parent"] is not None:
            covered[e["args"]["parent"]] += e["dur"]
    host_s, self_s, spans = defaultdict(float), defaultdict(float), {}
    parents = defaultdict(set)
    for e in host:
        name = e["name"]
        host_s[name] += e["dur"] / 1e6
        self_s[name] += (e["dur"] - covered[e["args"]["id"]]) / 1e6
        spans[name] = spans.get(name, 0) + 1
        parents[name].add(e["args"]["parent"])
    return {"windows_s": [(b - a) / 1e6 for a, b in
                          export["otherData"]["windows"]],
            **program_trace.idle_gaps(export),
            "device_ms": device_ms_by_span(export),
            "host_s": dict(host_s), "self_s": dict(self_s), "spans": spans,
            "parents": {k: len(v) for k, v in parents.items()}}


def device_ms_by_span(export):
    """Device ms of an export's intervals by span name: an interval counts
    under its span and under each of that span's ancestors, once a name;
    an interval of no span under ``trace.OUTSIDE``."""
    parent, name = {}, {}
    for e in export["traceEvents"]:
        if e.get("ph") == "X" and e["pid"] == program_trace.HOST:
            parent[e["args"]["id"]] = e["args"]["parent"]
            name[e["args"]["id"]] = e["name"]
    spent = defaultdict(float)
    for e in export["traceEvents"]:
        if e.get("ph") != "X" or e["pid"] != program_trace.DEVICE:
            continue
        span, seen = e["args"]["span"], set()
        if span is None:
            seen.add(program_trace.OUTSIDE)
        while span is not None:
            seen.add(name.get(span))
            span = parent.get(span)
        for found in seen - {None}:
            spent[found] += e["dur"] / 1e3
    return dict(spent)


def idle_gaps(program):
    """A pass's idle seconds by the span the host was in, as a result
    line's breakdown gives them: ``host in <span>``, largest first, at
    most 10."""
    return sorted(([f"host in {k}", s] for k, s in
                   program["idle_s"].items()), key=lambda p: -p[1])[:10]


def host_us(program, *names, own=False):
    """Host us a call in the spans ``names`` (with ``own``, their self
    time), or None where the pass recorded none of them."""
    spent = program["self_s" if own else "host_s"]
    seconds = [spent[n] for n in names if n in spent]
    return sum(seconds) / program["calls"] * 1e6 if seconds else None


def device_ms(program, name, per=None):
    """Device ms under the span ``name`` (its descendants' intervals
    included): a call; with ``per`` a span name, a span of that name;
    with ``per='parents'``, each distinct span that held ``name``.  None
    where the pass recorded no such interval or span."""
    if name not in program["device_ms"]:
        return None
    n = (program["calls"] if per is None else
         program["parents"].get(name) if per == "parents" else
         program["spans"].get(per))
    return program["device_ms"][name] / n if n else None


def idle_in_program_us(program):
    """Device-idle us a call that the tracer charged to a program span,
    not to ``trace.OUTSIDE``."""
    idle = sum(s for k, s in program["idle_s"].items()
               if k != program_trace.OUTSIDE)
    return idle / program["calls"] * 1e6


# what a per-layer metric would read of a replaying cell's pass, by
# quantity (a call: a replayed call)
QUANTITIES = {
    "idle_in_program_us": idle_in_program_us,
    "upload_host_us": lambda p: host_us(p, "resample.upload"),
    "wrapper_host_us": lambda p: host_us(p, "kernel_a", own=True),
    "validate_host_us": lambda p: host_us(p, "wbp.validate", "wbp.plan"),
    "filter_ms": lambda p: device_ms(p, "wbp.filter"),
    "stack_sum_ms": lambda p: device_ms(p, "project.sum", per="parents"),
    "update_ms": lambda p: device_ms(p, "sirt.update",
                                     per="sirt.iteration"),
    "matrices_host_us": lambda p: host_us(p, "project.matrices")}


def quantities(program):
    """:data:`QUANTITIES` of a pass that ran a call, those it recorded."""
    if not program.get("calls"):
        return {}
    found = {k: f(program) for k, f in QUANTITIES.items()}
    return {k: v for k, v in found.items() if v is not None}

"""The port's tracer (``voltools_tpu_torch.utils.trace``): off by default
and free there, the spans of the four instrumented entry points, results
unchanged by it, its counters, ``idle_gaps`` and the export.

The CPU tests import torch and the port only.  The card tests (marker
``cuda``, skipped without a CUDA device) run on the card's machine with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_trace.py -q
"""

import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import voltools_tpu_torch as vt
from voltools_tpu_torch.kernels.planner import route
from voltools_tpu_torch.models import (TiltSeriesProjector, sirt_reconstruct,
                                       wbp_reconstruct)
from voltools_tpu_torch.utils import trace, transform_matrix

SHAPE = (8, 12, 10)
ITERATIONS = 2
ANGLES = np.arange(-30.0, 31.0, 15.0)
RESAMPLE = {"resample", "resample.route", "resample.upload"}
WALK = {"resample.walk_patch", "kernel_a"}


@pytest.fixture(autouse=True)
def tracer_off():
    yield
    trace.stop()


def _data(device="cpu"):
    rng = np.random.default_rng(7)
    vol = rng.random(SHAPE).astype(np.float32)
    m = transform_matrix(rotation=(20, 10, 5),
                         center=tuple((s - 1) / 2 for s in SHAPE))
    proj = TiltSeriesProjector(vol, device="cpu")
    ms = proj.tilt_matrices(ANGLES, tilt_axis=0)
    projs = proj.project(ANGLES, tilt_axis=0)
    if device != "cpu":
        projs = torch.as_tensor(projs, device=device)
    return vol, m, ms, projs


def _entry(name, device="cpu"):
    """A call of the instrumented entry point ``name`` at a tiny size,
    returning its result as numpy."""
    vol, m, ms, projs = _data(device)
    if name == "affine":
        return lambda: vt.affine(vol, m, device=device)
    if name == "StaticVolume.affine":
        sv = vt.StaticVolume(vol, device=device)
        return lambda: sv.affine(m)
    if name == "wbp_reconstruct":
        return lambda: wbp_reconstruct(projs, ms, SHAPE, device=device)
    return lambda: sirt_reconstruct(projs, ms, SHAPE, iterations=ITERATIONS,
                                    device=device)


def _sirt_kernel_spans():
    """The forward's spans as the planner routes the tilt series."""
    _, _, ms, _ = _data()
    if route(ms, SHAPE, "linear").plan is None:
        return WALK
    return {"kernel_b"}


def _expected(name):
    if name == "affine":
        return RESAMPLE | WALK
    if name == "StaticVolume.affine":
        return {"api.affine"} | RESAMPLE | WALK
    if name == "wbp_reconstruct":
        # kernel_c.table is on the CUDA path of the wrapper (the card test)
        return {"api.wbp", "wbp.validate", "wbp.plan", "wbp.filter",
                "kernel_c", "wbp.scale"}
    return ({"api.sirt", "sirt.validate", "sirt.normalise",
             "sirt.iteration", "sirt.forward", "sirt.update",
             "sirt.adjoint", "kernel_c", "project.sum"} | RESAMPLE
            | _sirt_kernel_spans())


ENTRIES = ["affine", "StaticVolume.affine", "wbp_reconstruct",
           "sirt_reconstruct"]


def _spans(export):
    return [e for e in export["traceEvents"]
            if e["ph"] == "X" and e["pid"] == trace.HOST]


def _counted():
    """The counters :func:`trace.count` keeps (not those read from the
    kernels' state)."""
    return {k: v for k, v in trace.counts().items()
            if not k.startswith(("launches.", "load.", "build."))}


def _traced(call, device=False):
    trace.start(device=device)
    try:
        result = call()
    finally:
        trace.stop()
    return result, trace.export()


@pytest.mark.parametrize("name", ENTRIES)
def test_off_by_default_records_nothing_and_reads_no_clock(name,
                                                           monkeypatch):
    call = _entry(name)
    call()                                  # builds and plans once
    before = len(trace.export()["traceEvents"])
    counted = _counted()
    reads = []
    clock = time.perf_counter_ns
    monkeypatch.setattr(time, "perf_counter_ns",
                        lambda: reads.append(1) or clock())
    # one shared null context
    assert trace.span("a") is trace.span("b", device=True)
    call()
    monkeypatch.setattr(time, "perf_counter_ns", clock)
    assert reads == []
    assert len(trace.export()["traceEvents"]) == before
    assert _counted() == counted


@pytest.mark.parametrize("name", ENTRIES)
def test_on_records_the_named_spans_nested_in_one_call(name):
    _, export = _traced(_entry(name))
    spans = _spans(export)
    assert {e["name"] for e in spans} == _expected(name)
    by_id = {e["args"]["id"]: e for e in spans}
    calls = {e["args"]["call"] for e in spans}
    assert len(calls) == 1
    (root,) = [e for e in spans if e["args"]["parent"] is None]
    assert calls == {root["args"]["id"]}
    for e in spans:
        parent = by_id.get(e["args"]["parent"])
        if parent is not None:
            assert parent["tid"] == e["tid"]
            assert parent["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"]
    names = [e["name"] for e in spans]
    if name == "sirt_reconstruct":
        assert names.count("sirt.iteration") == ITERATIONS
        assert names.count("sirt.forward") == ITERATIONS
        assert names.count("sirt.adjoint") == ITERATIONS
        assert names.count("sirt.update") == 2 * ITERATIONS
        assert names.count("kernel_c") == ITERATIONS + 1
        for e in spans:
            if e["name"] in ("sirt.forward", "sirt.update", "sirt.adjoint"):
                assert by_id[e["args"]["parent"]]["name"] == "sirt.iteration"
    if name.endswith("affine"):
        (kernel,) = [e for e in spans if e["name"] == "kernel_a"]
        assert by_id[kernel["args"]["parent"]]["name"] == "resample"


def test_each_call_has_its_own_call_id():
    sv = vt.StaticVolume(_data()[0], device="cpu")
    m = _data()[1]
    _, export = _traced(lambda: [sv.affine(m) for _ in range(3)])
    spans = _spans(export)
    roots = [e for e in spans if e["name"] == "api.affine"]
    assert len(roots) == 3
    assert {e["args"]["call"] for e in spans} == {
        e["args"]["id"] for e in roots}


def _matcher(orientations):
    rng = np.random.default_rng(5)
    box = 8
    g = np.arange(box) - box // 2
    r2 = g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2
    tm = vt.TemplateMatcher(rng.random((16, 20, 18)).astype(np.float32),
                            rng.random((box,) * 3).astype(np.float32),
                            (r2 <= 9).astype(np.float32), device="cpu")
    ms = np.stack([transform_matrix(rotation=(a, 10, 0),
                                    center=(box // 2,) * 3)
                   for a in np.linspace(0, 90, orientations)])
    return tm, ms


@pytest.mark.parametrize("orientations", [1, 3])
def test_matching_spans_nest_in_match_and_count_each_orientation(
        orientations):
    tm, ms = _matcher(orientations)
    tm.match(ms)
    off = tm.result()
    tm.reset()
    before = trace.counts()
    _, export = _traced(lambda: tm.match(ms))
    after = trace.counts()
    spans = _spans(export)
    by_id = {e["args"]["id"]: e for e in spans}
    (root,) = [e for e in spans if e["args"]["parent"] is None]
    assert root["name"] == "match"
    names = [e["name"] for e in spans]
    for name in ("match.template", "match.correlate", "match.update"):
        assert names.count(name) == orientations
    for e in spans:
        if e["name"].startswith("match."):
            assert by_id[e["args"]["parent"]]["name"] == "match"
        elif e is not root:
            # the template's rotation: StaticVolume.affine and its launch
            ancestor = e
            while ancestor["args"]["parent"] != root["args"]["id"]:
                ancestor = by_id[ancestor["args"]["parent"]]
            assert ancestor["name"] == "match.template"
    assert names.count("api.affine") == orientations
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("match.orientations", "match.transforms")}
    assert moved == {"match.orientations": orientations,
                     "match.transforms": 2 * orientations}
    for a, b in zip(off, tm.result()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ENTRIES)
def test_results_are_bit_identical_with_tracing_on(name):
    off = _entry(name)()
    on, _ = _traced(_entry(name))
    assert off.dtype == on.dtype and np.array_equal(off, on)


def test_route_counters_count_each_launch_and_cpu_ships_nothing():
    sv = vt.StaticVolume(_data()[0], device="cpu")
    m = _data()[1]
    before = trace.counts()
    _traced(lambda: [sv.affine(m) for _ in range(3)])
    after = trace.counts()
    key = "route.kernel_a.speed"
    assert after.get(key, 0) - before.get(key, 0) == 3
    # no host-to-device bytes on the CPU: the card test counts them
    assert after.get("upload_bytes", 0) == before.get("upload_bytes", 0)


def test_route_counters_match_the_resample_spans():
    call = _entry("sirt_reconstruct")
    before = trace.counts()
    _, export = _traced(call)
    after = trace.counts()
    routed = sum(after[k] - before.get(k, 0) for k in after
                 if k.startswith("route."))
    assert routed == sum(e["name"] == "resample" for e in _spans(export))
    assert routed == ITERATIONS + 1         # one chunk a forward here


def test_counters_lose_no_update_across_threads():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.start()
    try:
        before = trace.counts().get("test.threads", 0)
        workers = [threading.Thread(
            target=lambda: [trace.count("test.threads") for _ in range(5000)])
            for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        trace.stop()
        sys.setswitchinterval(switch)
    assert trace.counts()["test.threads"] - before == 16 * 5000


def test_builds_and_loads_are_read_from_the_build_state(monkeypatch):
    from voltools_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "_LOADED", {"a": object(), "b": object()})
    monkeypatch.setattr(_build, "BUILD_LOG", {"b": (1.0, "")})
    found = {k: v for k, v in trace.counts().items()
             if k.startswith(("load.", "build."))}
    assert found == {"load.a": 1, "load.b": 1, "build.b": 1}


def _synthetic(host, device, windows):
    """An export of host spans (name, ts, end) and device intervals (ts,
    end), in us."""
    events = [{"name": n, "ph": "X", "pid": trace.HOST, "tid": 1, "ts": a,
               "dur": b - a, "args": {"id": i + 1}}
              for i, (n, a, b) in enumerate(host)]
    events += [{"name": "work", "ph": "X", "pid": trace.DEVICE, "tid": 0,
                "ts": a, "dur": b - a, "args": {"span": None}}
               for a, b in device]
    return {"traceEvents": events, "otherData": {"windows": windows}}


IDLE_CASES = {
    # A holds B; the device intervals overlap; C stands alone; the rest of
    # the window has no span open
    "nested_overlapping_and_outside": (
        [("A", 10, 60), ("B", 20, 40), ("C", 70, 80)],
        [(0, 15), (12, 25), (50, 55)], [[0, 100]],
        {"B": 15, "A": 15, "C": 10, trace.OUTSIDE: 30}, 30),
    # device work past the window is clipped; a gap between two windows
    # is no part of the wall
    "clipped_and_two_windows": (
        [("A", 5, 30)], [(0, 10), (95, 120)], [[0, 40], [90, 100]],
        {"A": 20, trace.OUTSIDE: 15}, 15),
    "no_span_open": ([], [(10, 20)], [[0, 50]], {trace.OUTSIDE: 40}, 10),
    # spans that end where the next starts: the later one holds the instant
    "abutting": ([("A", 0, 10), ("B", 10, 20)], [], [[0, 20]],
                 {"A": 10, "B": 10}, 0),
}


@pytest.mark.parametrize("case", IDLE_CASES)
def test_idle_gaps_on_a_synthetic_export(case):
    host, device, windows, idle, busy = IDLE_CASES[case]
    gaps = trace.idle_gaps(_synthetic(host, device, windows))
    assert gaps["idle_s"] == pytest.approx({k: v / 1e6
                                            for k, v in idle.items()})
    assert gaps["busy_s"] == pytest.approx(busy / 1e6)
    wall = sum(b - a for a, b in windows) / 1e6
    assert gaps["wall_s"] == pytest.approx(wall)
    assert sum(gaps["idle_s"].values()) + gaps["busy_s"] == \
        pytest.approx(wall)


def test_idle_gaps_of_a_cpu_run_charge_the_whole_wall():
    _, export = _traced(_entry("sirt_reconstruct"))
    gaps = trace.idle_gaps(export)
    assert gaps["busy_s"] == 0
    assert sum(gaps["idle_s"].values()) == pytest.approx(gaps["wall_s"])
    assert set(gaps["idle_s"]) <= _expected("sirt_reconstruct") | {
        trace.OUTSIDE}


class _FakeEvent:
    """A recorded CUDA event at ``ms`` on the device's clock."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_export_starts_device_work_after_the_work_before_it(monkeypatch):
    # the anchor: device 0 ms is host 1_000_000 ns; work ends at device
    # 0.010, 0.030 and 0.020 ms (stream 7) and 0.025 ms (stream 8)
    events = [_FakeEvent(ms) for ms in (0.0, 0.010, 0.030, 0.020, 0.025)]
    monkeypatch.setattr(trace, "_EVENTS", {0: events})
    monkeypatch.setattr(trace, "_ANCHORS", {0: [(1_000_000, 0, 2_000)]})
    monkeypatch.setattr(trace, "_WINDOWS", [[1_000_000, 1_040_000]])
    monkeypatch.setattr(trace, "_SPANS", [
        (1, None, 1, 5, "a", 1_000_000, 1_040_000, None)])
    # (owner, device, anchor, the host's exit from the block, slot, stream)
    monkeypatch.setattr(trace, "_WORK", [
        (1, 0, 0, 1_002_000, 1, 7),      # made at 2 us, ends at 10 us
        (1, 0, 0, 1_012_000, 3, 7),      # queued at 12 us, ends at 20 us
        (1, 0, 0, 1_013_000, 2, 7),      # queued behind it, ends at 30 us
        (1, 0, 0, 1_015_000, 4, 8)])     # another stream: from 15 us
    monkeypatch.setattr(trace, "_device_counters", dict)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    work = [(e["ts"], e["ts"] + e["dur"]) for e in trace.export()[
        "traceEvents"] if e.get("ph") == "X" and e["pid"] == trace.DEVICE]
    assert work == pytest.approx([(2, 10), (12, 20), (20, 30), (15, 25)])


def test_export_takes_the_drift_out_between_anchors(monkeypatch):
    # the device's clock runs 1% slow against the host's: anchors at host
    # 0 and 1_010_000 ns are 1 ms apart on the device; work ends at device
    # 0.5 ms, so at host 505 us; work after the last anchor goes by it
    events = [_FakeEvent(ms) for ms in (0.0, 1.0, 0.5, 1.2)]
    monkeypatch.setattr(trace, "_EVENTS", {0: events})
    monkeypatch.setattr(trace, "_ANCHORS", {0: [(0, 0, 1_000),
                                                (1_010_000, 1, 1_000)]})
    monkeypatch.setattr(trace, "_WINDOWS", [[0, 1_300_000]])
    monkeypatch.setattr(trace, "_SPANS", [])
    monkeypatch.setattr(trace, "_WORK", [(None, 0, 0, 400_000, 2, 7),
                                         (None, 0, 1, 1_100_000, 3, 7)])
    monkeypatch.setattr(trace, "_device_counters", dict)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    work = [(e["ts"], e["ts"] + e["dur"]) for e in trace.export()[
        "traceEvents"] if e.get("ph") == "X" and e["pid"] == trace.DEVICE]
    assert work == pytest.approx([(400, 505), (1100, 1210)])


def test_the_export_is_trace_event_json():
    _, export = _traced(_entry("StaticVolume.affine"))
    loaded = json.loads(json.dumps(export))
    events = loaded["traceEvents"]
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} == {
        "host", "device"}
    spans = [e for e in events if e["ph"] == "X"]
    assert spans
    for e in spans:
        assert isinstance(e["name"], str) and e["pid"] in (trace.HOST,
                                                           trace.DEVICE)
        assert isinstance(e["tid"], int)
        assert np.isfinite(e["ts"]) and e["dur"] >= 0
    other = loaded["otherData"]
    assert other["clock"] == "time.perf_counter_ns"
    (window,) = other["windows"]
    assert window[0] == 0 and all(
        window[0] <= e["ts"] and e["ts"] + e["dur"] <= window[1]
        for e in spans)
    assert "route.kernel_a.speed" in other["counters"]


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _sleep_cycles(ms):
    torch.cuda._sleep(10 ** 6)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    torch.cuda.synchronize()
    return int(ms * 10 ** 7 / a.elapsed_time(b))


def _wait(stream):
    """Poll ``stream`` until its work is done: the work ended after the
    start of the last poll that found it running and before the return of
    the one that found it done."""
    last = time.perf_counter_ns()
    while True:
        t = time.perf_counter_ns()
        if stream.query():
            return last, time.perf_counter_ns()
        last = t


@pytest.mark.cuda
def test_the_anchor_places_a_device_sleep_on_the_host_clock(card):
    cycles = _sleep_cycles(2.0)
    stream = torch.cuda.current_stream()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    sleep_us = a.elapsed_time(b) * 1e3
    trace.start(device=True)
    seen = []
    for i in range(10):
        if i % 5 == 0:
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
    assert len(work) == 10
    for e, (lo, hi) in zip(work, seen):
        # the sleep's length, and its end within 10 us of the bracket the
        # host saw it end in
        assert abs(e["dur"] - sleep_us) < 0.1 * sleep_us
        end = origin + (e["ts"] + e["dur"]) * 1e3
        assert lo - 10e3 < end < hi + 10e3


def _queued_busy_ms(calls):
    """Device ms of ``calls`` queued behind a sleep (no idle between
    them)."""
    cycles = _sleep_cycles(200.0)
    torch.cuda.synchronize()
    sleep_end, done = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
    torch.cuda._sleep(cycles)
    sleep_end.record()
    for call in calls:
        call()
    done.record()
    torch.cuda.synchronize()
    return sleep_end.elapsed_time(done)


@pytest.mark.cuda
def test_wbp_device_intervals_cover_its_queued_busy_time(card):
    # the benchmark's tomogram: the card's work outweighs the host's
    # dispatch at the start of each call, inside the filter's pair
    shape = (256, 512, 512)
    rng = np.random.default_rng(3)
    proj = TiltSeriesProjector(rng.random(shape).astype(np.float32))
    angles = np.arange(-60.0, 61.0, 3.0)
    ms = proj.tilt_matrices(angles, tilt_axis=0)
    projs = proj.project(angles, tilt_axis=0, output="device")

    def call():
        return wbp_reconstruct(projs, ms, shape, output="device")

    off = call()
    for _ in range(3):
        call()
    n = 10
    busy_ms = _queued_busy_ms([call] * n) / n
    trace.start(device=True)
    for _ in range(n):
        on = call()
        torch.cuda.synchronize()
    trace.stop()
    export = trace.export()
    gaps = trace.idle_gaps(export)
    assert torch.equal(off, on)
    names = {e["name"] for e in _spans(export)}
    assert "kernel_c.table" in names and "kernel_c" in names
    covered_ms = gaps["busy_s"] * 1e3 / n
    assert 0.95 * busy_ms <= covered_ms <= 1.05 * busy_ms
    assert sum(gaps["idle_s"].values()) + gaps["busy_s"] == \
        pytest.approx(gaps["wall_s"], rel=1e-6)


@pytest.mark.cuda
def test_uploads_are_counted_on_the_card(card):
    vol, m, ms, projs = _data(card)
    sv = vt.StaticVolume(vol)
    out = torch.empty(SHAPE, device=card)
    sv.affine(m, output=out)
    before = trace.counts()
    _traced(lambda: ([sv.affine(m, output=out) for _ in range(3)],
                     wbp_reconstruct(projs, ms, SHAPE, output="device")))
    after = trace.counts()
    # 3 matrices of 64 bytes, the row-gather table of 16 bytes a tilt
    assert after["upload_bytes"] - before.get("upload_bytes", 0) == \
        3 * 64 + 16 * len(ms)
    assert after["launches.affine_resample"] - before[
        "launches.affine_resample"] == 3

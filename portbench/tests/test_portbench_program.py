"""The program pass (``drivers/_program.py``) on the CPU: two rounds make
two windows whose idle and busy time make up their wall, each quantity
reads a number off a synthetic export and nothing off an empty one, and
the template-matching driver's record is as the benchmark reads it."""

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import _program
from portbench.tests import _small  # noqa: F401  (the tests' thread count)
from portbench.tests.test_portbench_matching import SMALL
import voltools_tpu_torch as vt
from voltools_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def tracer_off():
    yield
    trace.stop()


def _cpu_cell(name="rot250-linear"):
    return harness.make_cell(name, 2 ** 31 + 3, 0.5, True, "cpu",
                             config_overrides={"shape": [12, 10, 8]})


def test_two_rounds_make_two_windows_whose_idle_and_busy_are_their_wall():
    rng = np.random.default_rng(3)
    sv = vt.StaticVolume(rng.random((12, 10, 8)).astype(np.float32),
                         device="cpu")
    ms = vt.utils.transform_matrix(rotation=(20, 10, 5), center=(5.5, 4.5,
                                                                   3.5))
    out = np.empty((12, 10, 8), np.float32)

    def call():
        time.sleep(0.002)             # host time outside any span
        sv.affine(ms, output=out)

    prog = _program.program_pass(_cpu_cell(), [[call] * 3, [call] * 2],
                                 sync_each=True)
    assert prog["calls"] == 5
    assert len(prog["windows_s"]) == 2
    assert prog["wall_s"] == pytest.approx(sum(prog["windows_s"]))
    assert sum(prog["idle_s"].values()) + prog["busy_s"] == \
        pytest.approx(prog["wall_s"])
    # no device work on the CPU: the wall is all idle, by the span open
    assert prog["busy_s"] == 0 and prog["device_ms"] == {}
    assert prog["idle_s"][trace.OUTSIDE] >= 5 * 0.002
    assert prog["idle_s"]["api.affine"] > 0
    # the windows open after the anchor and close at the next mark: the
    # rounds' own wall lies within them
    assert prog["round_s"] <= prog["wall_s"]
    assert prog["round_s"] == pytest.approx(prog["wall_s"], rel=0.2)
    assert prog["spans"]["api.affine"] == 5
    assert prog["parents"]["resample"] == 5        # one an api.affine
    assert prog["self_s"]["resample"] < prog["host_s"]["resample"]
    assert prog["host_s"]["resample"] <= prog["host_s"]["api.affine"]
    assert prog["counts"]["route.kernel_a.speed"] == 5


def test_the_template_matching_record_keeps_its_keys():
    c = harness.make_cell("tm512-match", 2 ** 31 + 77, 0.5, True, "cpu",
                          config_overrides=SMALL)
    c.traffic["warmup_s"] = 0.2
    c.traffic["replay"]["calls"] = 2
    driver = harness.load_module("drivers", c.traffic["driver"]).Driver(c)
    driver.setup()
    record = driver.window()
    driver.trace(record)
    traced = record["trace"]
    assert set(traced) == {"orientations", "counts", "match_ms", "wall_s",
                           "busy_s", "breakdown"}
    assert traced["counts"] == {"match.orientations": 32,
                                "match.transforms": 64}
    assert traced["orientations"] == 32
    # no device intervals on the CPU: no device ms, no busy time
    assert traced["match_ms"] == {}
    assert traced["wall_s"] is None and traced["busy_s"] is None
    assert traced["breakdown"]["device_ops"] == []
    gaps = traced["breakdown"]["idle_gaps"]
    assert 0 < len(gaps) <= 10
    assert all(label.startswith("host in ") for label, _ in gaps)
    assert [s for _, s in gaps] == sorted((s for _, s in gaps),
                                          reverse=True)
    driver.release()


def _synthetic():
    """An export of two calls of each instrumented path, in us: host spans
    (name, id, parent, ts, end) and device intervals (span id, ts, end)
    within one window of 0-1000."""
    host = [
        # a linear rotation: 10 us upload, 20 us wrapper
        ("api.affine", 1, None, 0, 60), ("resample", 2, 1, 5, 55),
        ("resample.upload", 3, 2, 10, 20), ("kernel_a", 4, 2, 30, 50),
        # WBP: validate, plan, filter (device 40 us)
        ("api.wbp", 5, None, 100, 300), ("wbp.validate", 6, 5, 100, 150),
        ("wbp.plan", 7, 5, 150, 160), ("wbp.filter", 8, 5, 160, 200),
        # SIRT: a normalise's forward and an iteration's, each two sums
        ("api.sirt", 9, None, 300, 700), ("sirt.normalise", 10, 9, 300, 400),
        ("project.sum", 11, 10, 310, 320), ("project.sum", 12, 10, 330, 340),
        ("sirt.iteration", 13, 9, 400, 700), ("sirt.forward", 14, 13, 400,
                                                500),
        ("project.sum", 15, 14, 410, 420), ("project.sum", 16, 14, 430, 440),
        ("sirt.update", 17, 13, 500, 550), ("sirt.update", 18, 13, 600, 650),
        # a projection: its matrices
        ("api.project", 19, None, 700, 900),
        ("project.matrices", 20, 19, 700, 780)]
    device = [(3, 20, 25), (4, 50, 90), (8, 160, 200), (11, 320, 330),
              (12, 340, 350), (15, 420, 430), (16, 440, 450),
              (17, 550, 560), (18, 650, 660), (None, 950, 960)]
    events = [{"name": n, "ph": "X", "pid": trace.HOST, "tid": 1, "ts": a,
               "dur": b - a, "args": {"id": i, "parent": p, "call": i}}
              for n, i, p, a, b in host]
    names = {i: n for n, i, *_ in host}
    events += [{"name": names.get(s, trace.OUTSIDE), "ph": "X",
                "pid": trace.DEVICE, "tid": 0, "ts": a, "dur": b - a,
                "args": {"span": s}} for s, a, b in device]
    return {"traceEvents": events, "otherData": {"windows": [[0, 1000]]}}


def _pass(export, calls):
    return {"calls": calls, "round_s": 1e-3, "counts": {},
            **_program.summary(export)}


def test_each_quantity_reads_a_synthetic_export():
    prog = _pass(_synthetic(), calls=2)
    found = _program.quantities(prog)
    assert set(found) == set(_program.QUANTITIES)
    assert all(isinstance(v, float) for v in found.values()), found
    assert found["upload_host_us"] == pytest.approx(10 / 2)
    assert found["wrapper_host_us"] == pytest.approx(20 / 2)
    assert found["validate_host_us"] == pytest.approx(60 / 2)
    assert found["matrices_host_us"] == pytest.approx(80 / 2)
    assert found["filter_ms"] == pytest.approx(0.040 / 2)
    # four sums of 10 us over two forward sweeps; two updates of 10 us in
    # one iteration
    assert found["stack_sum_ms"] == pytest.approx(0.020)
    assert found["update_ms"] == pytest.approx(0.020)
    outside = prog["idle_s"][trace.OUTSIDE]
    assert found["idle_in_program_us"] == pytest.approx(
        (prog["wall_s"] - prog["busy_s"] - outside) / 2 * 1e6)
    # the interval of no span is busy time, and no span's
    assert prog["device_ms"][trace.OUTSIDE] == pytest.approx(0.010)
    # a parent's device time holds its children's
    assert prog["device_ms"]["api.sirt"] == pytest.approx(0.060)
    assert prog["device_ms"]["sirt.iteration"] == pytest.approx(0.040)
    # self time: the span less its children
    assert prog["self_s"]["resample"] == pytest.approx(20e-6)
    assert prog["self_s"]["api.affine"] == pytest.approx(10e-6)


def test_each_quantity_reads_nothing_off_an_empty_export():
    empty = {"traceEvents": [], "otherData": {"windows": []}}
    assert _program.quantities(_pass(empty, calls=0)) == {}
    # a pass with calls and no idle time: none idle, nothing else
    assert _program.quantities(_pass(empty, calls=2)) == {
        "idle_in_program_us": 0.0}


def test_a_span_the_parent_program_lacks_reads_nothing():
    export = _synthetic()
    export["traceEvents"] = [e for e in export["traceEvents"]
                             if e["name"] not in ("project.matrices",
                                                  "wbp.filter")]
    found = _program.quantities(_pass(export, calls=2))
    assert "matrices_host_us" not in found and "filter_ms" not in found
    assert "validate_host_us" in found


def test_the_idle_gaps_name_program_spans_largest_first():
    program = {"idle_s": {f"span{i}": float(i) for i in range(12)}}
    assert _program.idle_gaps(program) == [[f"host in span{i}", float(i)]
                                           for i in range(11, 1, -1)]


def test_the_pass_runs_on_torch_tensors_of_the_cpu():
    # a round whose calls queue torch work only: the counters it moved
    # are none, and the round's calls are counted
    x = torch.ones(8)
    prog = _program.program_pass(_cpu_cell(), [[lambda: x.add_(1)] * 4],
                                 sync_each=False)
    assert prog["calls"] == 4 and prog["counts"] == {}
    assert prog["spans"] == {} and prog["idle_s"] == pytest.approx(
        {trace.OUTSIDE: prog["wall_s"]})

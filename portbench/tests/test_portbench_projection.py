"""The tilt-series projection cell (``tomo512-project``) at a size a CPU
test holds: its traffic is a fresh offset series about array axis 2 whose
matrices are the reference's, the planner sends the linear projector's
launches to the slab kernel's row path and the cubic one's to the walk
kernel at the tomogram's shape, a run is correct, its control and a fault
are not."""

import time

import numpy as np
import pytest
import torch

from portbench import control, harness, traffic
from portbench.tests import _small  # noqa: F401  (the tests' thread count)
from voltools_tpu_torch import StaticVolume
from voltools_tpu_torch.kernels import planner
from voltools_tpu_torch.models import projections

CELL = "tomo512-project"
SHAPE = [16, 32, 24]


def _cell(seed=2 ** 31 + 5):
    return harness.make_cell(CELL, seed, 0.5, False, "cpu",
                             config_overrides={"shape": SHAPE})


def _driver(seed=2 ** 31 + 5):
    c = _cell(seed)
    driver = harness.load_module("drivers", c.traffic["driver"]).Driver(c)
    driver.setup()
    return driver


def test_the_traffic_is_a_fresh_offset_series_the_reference_follows():
    c = harness.make_cell(CELL, 1, 1, False, "cpu")
    assert c.config["projection_axis"] == 0 and c.config["reduced"] == []
    assert c.traffic["tilt_axis"] == 0
    assert c.traffic["interpolations"] == ["linear", "filt_bspline"]
    driver = _driver()
    angles = driver.pool
    assert angles.shape[1] == 41
    assert np.allclose(np.diff(angles, axis=1), 3.0)
    offsets = angles[:, 20]
    assert np.all(np.abs(offsets) <= 1.5) and offsets.std() > 0.5
    assert len(driver.sample) == 4 and len(driver.kept) == 8
    # the reference's matrices are the projectors' own, position 0 of
    # 'rzxz': a tilt about array axis 2
    for p in driver.projectors:
        got = p.tilt_matrices(angles[0], tilt_axis=0)
        want = traffic.tilt_series(angles[0], SHAPE)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert np.all(got[:, 2] == [0, 0, 1, 0])


def test_at_the_tomogram_linear_takes_the_row_path_and_cubic_the_walk():
    shape = (256, 512, 512)
    chunk = StaticVolume.batch_chunk(shape)
    assert chunk == 8
    ms = traffic.tilt_series(np.arange(-60.0, 61.0, 3.0) + 0.7, shape)
    for pos in range(0, 40, chunk):
        assert planner.route(ms[pos:pos + chunk], shape, "linear",
                             "constant", shape).rule == "rows"
        plan = planner.route(ms[pos:pos + chunk], shape, "filt_bspline",
                             "constant", shape)
        assert plan[0] is None


def test_a_small_run_is_correct():
    line = harness.run_cell(_cell(), time.perf_counter())
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] % 82 == 0 and line["attempted"] >= 82
    assert set(line["metrics"]) == {"rotation_ms", "setup_s"}
    assert line["checks"]["max_rel_err"]["value"] < 1e-5


def test_the_bfloat16_control_fails_the_limit():
    driver = _driver()
    driver.window()
    driver.release()
    read = control.readings(driver, torch.bfloat16)
    limit = driver.cell.limits["max_rel_err"]
    assert read["program"]["max_rel_err"] < limit
    assert read["control"]["max_rel_err"] > limit


@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
def test_a_fault_in_either_projector_is_not_correct(monkeypatch,
                                                    interpolation):
    original = projections.project_stack

    def project_stack(volume, matrices, interp, mode, axis):
        result = original(volume, matrices, interp, mode, axis)
        if interp == interpolation:
            result[:, result.shape[1] // 2] += 0.01 * float(
                result.abs().max())
        return result

    monkeypatch.setattr(projections, "project_stack", project_stack)
    line = harness.run_cell(_cell(), time.perf_counter())
    assert not line["correct"] and line["failed"] > 0

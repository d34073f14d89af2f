"""The batched tilt-series cell (``rot250-tilt-batch``) at a size a CPU
test holds: its traffic is a shifted single-axis series whose every launch
the planner routes to the slab kernel's row path, a run is correct, its
control and a fault are not, and its least time a tilt at 250^3 is the
hand-worked one."""

import time

import numpy as np
import pytest
import torch

from portbench import control, harness, roofline
from portbench.tests import _small  # noqa: F401  (the tests' thread count)
import voltools_tpu_torch.volume as volume
from voltools_tpu_torch import StaticVolume
from voltools_tpu_torch.kernels import planner
from voltools_tpu_torch.utils import trace

CELL = "rot250-tilt-batch"
SHAPE = [24, 28, 20]


def _cell(seed=2 ** 31 + 5, trace=False):
    return harness.make_cell(CELL, seed, 0.5, trace, "cpu",
                             config_overrides={"shape": SHAPE})


@pytest.fixture
def on_the_cpu(monkeypatch):
    # output='device' needs a CUDA device; on the CPU it is the same stack
    monkeypatch.setattr(volume, "_check_output", lambda output, device: None)


def _driver(seed=2 ** 31 + 5):
    c = _cell(seed)
    driver = harness.load_module("drivers", c.traffic["driver"]).Driver(c)
    driver.setup()
    return driver


def test_the_traffic_is_a_shifted_series_about_axis_2(on_the_cpu):
    driver = _driver()
    pool = driver.pool.astype(np.float64)
    assert pool.shape[1] == driver.tr["batch"] == 41
    # the row axis is left alone, exactly
    assert np.all(pool[..., 2, :] == [0, 0, 1, 0])
    assert np.all(pool[..., :2, 2] == 0)
    # each series: the -60..60 tilts in 3-degree steps, one offset
    angles = np.degrees(np.arctan2(pool[..., 1, 0], pool[..., 0, 0]))
    steps = np.diff(angles, axis=1)
    assert np.allclose(np.abs(steps), 3.0, atol=1e-4)
    offsets = angles[:, 20]
    assert np.all(np.abs(offsets) <= 1.5 + 1e-4) and offsets.std() > 0.5
    # each tilt its own shift along axes 0 and 1 within 2 voxels
    c = (np.asarray(SHAPE, np.float64) - 1) / 2
    shift = pool[..., :3, 3] - (c - np.einsum("...ij,j->...i",
                                              pool[..., :3, :3], c))
    assert np.all(np.abs(shift[..., :2]) <= 2.0 + 1e-4)
    assert np.all(np.abs(shift[..., 2]) < 1e-4)
    assert shift[..., :2].std() > 0.5


def test_every_sampled_tilt_routes_to_the_row_path(on_the_cpu):
    driver = _driver()
    calls = sorted({i // driver.batch for i in driver.sample})
    chunk = StaticVolume.batch_chunk((250, 250, 250))
    for i in calls:
        for pos in range(0, driver.batch, chunk):
            ms = driver.pool[i, pos:pos + chunk]
            assert planner.route(ms, (250, 250, 250), "linear").rule \
                == "rows"
    before = trace.counts()
    trace.start()
    try:
        for i in calls:
            driver.sv.affine_batch(driver.pool[i], output="device")
    finally:
        trace.stop()
    moved = trace.counts().get("route.kernel_b.rows", 0) - before.get(
        "route.kernel_b.rows", 0)
    assert moved == len(calls) * -(-driver.batch
                                   // StaticVolume.batch_chunk(SHAPE))


def test_a_small_run_is_correct(on_the_cpu):
    line = harness.run_cell(_cell(), time.perf_counter())
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] % 41 == 0 and line["attempted"] >= 41
    assert set(line["metrics"]) == {"rotation_ms", "setup_s"}
    assert line["checks"]["max_rel_err"]["value"] < 1e-5


def test_the_bfloat16_control_fails_the_limit(on_the_cpu):
    driver = _driver()
    driver.window()
    driver.release()
    read = control.readings(driver, torch.bfloat16)
    limit = driver.cell.limits["max_rel_err"]
    assert read["program"]["max_rel_err"] < limit
    assert read["control"]["max_rel_err"] > limit


def test_a_fault_in_the_timed_path_is_not_correct(on_the_cpu, monkeypatch):
    original = volume._resample

    def resample(vol, matrices, *args, out=None):
        result = original(vol, matrices, *args, out=out)
        result[:, :, result.shape[2] // 2] += 0.01 * float(
            result.abs().max())
        return result

    monkeypatch.setattr(volume, "_resample", resample)
    line = harness.run_cell(_cell(), time.perf_counter())
    assert not line["correct"] and line["failed"] > 0


def test_the_least_time_a_tilt_at_250():
    # 41 tilts of 250^3 in launches of 34 and 7: the volume read once a
    # launch, each tilt written once; bytes bound it even with every
    # output voxel inside the volume
    shape = (250, 250, 250)
    voxels = 250 ** 3
    chunk = StaticVolume.batch_chunk(shape)
    assert chunk == 34
    launches = [roofline.resample_launch_ms(1, shape, shape, [voxels] * n)
                for n in (34, 7)]
    assert all(bound == "bytes" for _, bound in launches)
    per_tilt = sum(ms for ms, _ in launches) / 41
    assert per_tilt == pytest.approx(4.0 * voxels * 43 / 41 / 3.35e12 * 1e3)
    assert per_tilt == pytest.approx(0.01956, abs=5e-5)

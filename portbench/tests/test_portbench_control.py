"""The comparison that decides ``correct`` fails what it must: its control
(the reference in bfloat16 in the program's place) reads above every
cell's limit, and a run whose timed path is broken underneath comes out
not correct, once for each fault the cell can have.  At sizes a CPU test
holds, through the port's plain versions; the same harness, drivers and
reference as a run on the card, past its look for a card."""

import time

import pytest
import torch

from portbench import control, harness
from portbench.tests import _small
import voltools_tpu_torch.volume as volume
from voltools_tpu_torch.models import reconstruction

CELLS = list(_small.SHAPES)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_program_passes(name):
    driver = _small.driven(name)
    read = control.readings(driver, torch.bfloat16)
    limit = driver.cell.limits["max_rel_err"]
    assert read["program"]["max_rel_err"] < limit / 10
    assert read["control"]["max_rel_err"] > 2 * limit


def _run(name):
    return harness.run_cell(_small.cell(name), time.perf_counter())


def test_a_sound_run_is_correct():
    line = _run("rot250-linear")
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"


# -- faults planted in the timed path -----------------------------------

def _altered_rotation(original):
    def resample(vol, matrices, *args, out=None):
        result = original(vol, matrices, *args, out=out)
        result[result.shape[0] // 2] += 0.01 * float(result.abs().max())
        return result
    return resample


def _rotation_unwritten(original):
    def resample(vol, matrices, *args, out=None):
        return out if out is not None else original(vol, matrices, *args)
    return resample


@pytest.mark.parametrize("name", ["rot250-cubic", "rot250-linear"])
@pytest.mark.parametrize("fault", [_altered_rotation, _rotation_unwritten])
def test_rotation_faults_are_not_correct(monkeypatch, name, fault):
    monkeypatch.setattr(volume, "_resample", fault(volume._resample))
    line = _run(name)
    assert not line["correct"] and line["failed"] > 0


def _answer_altered(original):
    def result_out(result, output):
        result = result.clone()
        result[result.shape[0] // 2] += 0.01 * float(result.abs().max())
        return original(result, output)
    return "_result_out", result_out


def _state_unchanged(original):
    # every update adds nothing: the back-projection returns zeros
    def backproject(projs, minv, keep, out_shape, rowgather=None):
        return torch.zeros(out_shape, dtype=torch.float32,
                           device=projs.device)
    return "backproject", backproject


def _half_the_tilts(original):
    # the back-projection of the first half of the tilts, scaled to the
    # mean over all
    def backproject(projs, minv, keep, out_shape, rowgather=None):
        half = len(projs) // 2
        out = original(projs[:half].contiguous(), minv[:half], keep,
                       out_shape, rowgather)
        return out * (len(projs) / half)
    return "backproject", backproject


@pytest.mark.parametrize("name,fault", [
    ("tomo512-sirt", _answer_altered), ("tomo512-sirt", _state_unchanged),
    ("tomo512-sirt", _half_the_tilts), ("tomo512-wbp", _answer_altered),
    ("tomo512-wbp", _half_the_tilts)])
def test_reconstruction_faults_are_not_correct(monkeypatch, name, fault):
    attr, broken = fault(getattr(reconstruction,
                                 "_result_out" if fault is _answer_altered
                                 else "backproject"))
    monkeypatch.setattr(reconstruction, attr, broken)
    line = _run(name)
    assert not line["correct"] and line["failed"] > 0

"""The template-matching cell (``tm512-match``) and the batched rotation
cell (``rot250-cubic-batch``) at sizes a CPU test holds: their files
load, a run is correct, its control and its faults are not, and the
roofline count of ``roofline/matching.py`` is the hand-worked one."""

import time

import pytest
import torch

from portbench import control, harness
from portbench.roofline import matching as roofline
from portbench.tests import _small  # noqa: F401  (the tests' thread count)
import voltools_tpu_torch.volume as volume
from voltools_tpu_torch.models import matching

SMALL = {"shape": [24, 40, 36], "template_box": 12, "copies": 3,
         "mask": {"radius": 5.0, "edge_sigma": 1.0},
         "phantom": {"blobs": 6, "sigma": [1.0, 3.0], "region": [0.3, 0.7]},
         "template": {"blobs": 4, "sigma": [1.0, 2.0],
                      "region": [0.25, 0.75]}}


def _cell(trace=False, seed=2 ** 31 + 77):
    c = harness.make_cell("tm512-match", seed, 0.5, trace, "cpu",
                          config_overrides=SMALL)
    c.traffic["warmup_s"] = 0.2
    c.traffic["replay"]["calls"] = 2
    return c


def test_the_files_load_as_the_deployment_states():
    c = harness.make_cell("tm512-match", 1, 1, False, "cpu")
    assert c.config["shape"] == [256, 512, 512]
    assert c.config["template_box"] == 48
    assert c.config["mask"] == {"radius": 20.0, "edge_sigma": 2.0}
    assert c.config["tilt_range_deg"] == [-60.0, 60.0]
    assert c.config["reduced"] == [] and "search" in c.config
    assert c.traffic["orientations_per_call"] == 16
    assert set(c.limits) == {"max_rel_err", "index_mismatch"}
    assert c.limits["index_mismatch"] == 0


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(trace):
    line = harness.run_cell(_cell(trace), time.perf_counter())
    assert line["correct"] and line["failed"] == 0
    assert set(line["checks"]) == {"max_rel_err", "index_mismatch"}
    assert line["checks"]["index_mismatch"]["value"] == 0
    assert line["attempted"] % 16 == 0 and line["attempted"] >= 16
    if trace:
        # the counters count on the CPU; the device spans need the card
        assert line["metrics"]["transforms.tm"]["value"] == 2.0
        assert "rotate_ms.tm" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"rotation_ms", "setup_s"}


def test_the_bfloat16_control_fails_the_limit():
    c = _cell()
    driver = harness.load_module("drivers", c.traffic["driver"]).Driver(c)
    driver.setup()
    driver.window()
    driver.release()
    read = control.readings(driver, torch.bfloat16)
    limit = c.limits["max_rel_err"]
    assert read["program"]["max_rel_err"] < limit
    assert read["control"]["max_rel_err"] > 10 * limit


def _no_wedge(original):
    def template(self, m):
        self.sv.affine(m, output=self._box)
        t = self._box.clone()
        t.sub_((t * self._mask).sum() / self._n_mask)
        var = (t.square() * self._mask).sum() / self._n_mask
        return t.mul_(self._mask).mul_(var.rsqrt())
    return "_template", template


def _index_shifted(original):
    def score(self, m, index):
        return original(self, m, index + 1)
    return "_score", score


@pytest.mark.parametrize("fault", [_no_wedge, _index_shifted])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, fault):
    attr, broken = fault(getattr(matching.TemplateMatcher,
                                 "_score" if fault is _index_shifted
                                 else "_template"))
    monkeypatch.setattr(matching.TemplateMatcher, attr, broken)
    line = harness.run_cell(_cell(), time.perf_counter())
    assert not line["correct"] and line["failed"] == 1


def test_the_roofline_count_at_the_tomogram():
    n_bytes, flops = roofline.orientation_work((256, 512, 512))
    spectrum = 256 * 512 * 257 * 8
    voxels = 256 * 512 * 512
    assert n_bytes == spectrum + 4 * voxels + 4 * 4 * voxels
    assert n_bytes == pytest.approx(1.6116e9, rel=1e-4)
    assert flops == 2 * 2.5 * voxels * 26
    ms, bound = roofline.orientation_ms((256, 512, 512))
    assert bound == "bytes"
    assert ms == pytest.approx(n_bytes / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.481, abs=5e-4)


def _batch_cell():
    return harness.make_cell("rot250-cubic-batch", 2 ** 31 + 5, 0.5, False,
                             "cpu", config_overrides={"shape": [24, 28, 20]})


def _on_the_cpu(monkeypatch):
    # output='device' needs a CUDA device; on the CPU it is the same stack
    monkeypatch.setattr(volume, "_check_output", lambda output, device: None)


def test_the_batch_sweep_is_correct_in_calls_of_16(monkeypatch):
    _on_the_cpu(monkeypatch)
    line = harness.run_cell(_batch_cell(), time.perf_counter())
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] % 16 == 0


def test_a_fault_in_the_batch_sweep_is_not_correct(monkeypatch):
    _on_the_cpu(monkeypatch)
    original = volume._resample

    def resample(vol, matrices, *args, out=None):
        result = original(vol, matrices, *args, out=out)
        result[:, result.shape[1] // 2] += 0.01 * float(result.abs().max())
        return result

    monkeypatch.setattr(volume, "_resample", resample)
    line = harness.run_cell(_batch_cell(), time.perf_counter())
    assert not line["correct"] and line["failed"] > 0

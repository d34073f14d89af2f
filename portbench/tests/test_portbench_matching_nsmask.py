"""The template-matching cell under an ellipsoidal mask
(``tm512-nsmask-match``) at a size a CPU test holds: its files load as the
deployment states, a run is correct, its control and its faults are not,
and the roofline count of ``roofline/matching_nsmask.py`` is the
hand-worked one."""

import time

import pytest
import torch

from portbench import control, harness
from portbench.roofline import matching_nsmask as roofline
from portbench.tests import _small  # noqa: F401  (the tests' thread count)
from voltools_tpu_torch.models import matching

CELL = "tm512-nsmask-match"
SMALL = {"shape": [24, 40, 36], "template_box": 12, "copies": 3,
         "mask": {"semi_axes": [5.0, 3.0, 2.25], "edge_sigma": 1.0},
         "phantom": {"blobs": 6, "sigma": [1.0, 3.0], "region": [0.3, 0.7]},
         "template": {"blobs": 4, "sigma": [1.0, 2.0],
                      "spread": [3.5, 2.0, 1.25]}}


def _cell(trace=False, seed=2 ** 31 + 77):
    c = harness.make_cell(CELL, seed, 0.5, trace, "cpu",
                          config_overrides=SMALL)
    c.traffic["warmup_s"] = 0.2
    c.traffic["replay"]["calls"] = 2
    return c


def test_the_files_load_as_the_deployment_states():
    c = harness.make_cell(CELL, 1, 1, False, "cpu")
    tm512 = harness.make_cell("tm512-match", 1, 1, False, "cpu")
    differ = {k for k in c.config.keys() | tm512.config.keys()
              if c.config.get(k) != tm512.config.get(k)}
    assert differ == {"source", "deployment", "template", "mask", "assumed"}
    assert c.config["mask"] == {"semi_axes": [20.0, 12.0, 9.0],
                                "edge_sigma": 2.0}
    assert c.config["template"]["spread"] == [14.0, 8.0, 5.0]
    assert c.config["reduced"] == []
    assert len(c.config["source"]) <= 200
    assert c.traffic["orientations_per_call"] == 16
    assert c.traffic["driver"] == "template_match_nsmask"
    assert c.limits == tm512.limits


def test_the_mask_is_an_ellipsoid_that_the_matcher_rotates():
    driver = harness.load_module("drivers", "template_match_nsmask")
    mask = driver.ellipsoidal_mask(48, (20.0, 12.0, 9.0), 2.0, "cpu")
    assert mask[24, 24, 24] == 1 and mask[44, 24, 24] == 1
    assert mask[24, 36, 24] == 1 and mask[24, 24, 33] == 1
    assert mask[24, 38, 24] == pytest.approx(0.6065, abs=1e-4)  # 1 sigma
    assert float(mask.min()) >= 0 and float(mask.max()) == 1
    assert not matching._is_spherical(mask, (24, 24, 24))


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(trace):
    line = harness.run_cell(_cell(trace), time.perf_counter())
    assert line["correct"] and line["failed"] == 0
    assert set(line["checks"]) == {"max_rel_err", "index_mismatch"}
    assert line["checks"]["index_mismatch"]["value"] == 0
    assert line["attempted"] % 16 == 0 and line["attempted"] >= 16
    if trace:
        # the counters count on the CPU; the device spans need the card
        assert line["metrics"]["transforms.tm"]["value"] == 5.0
        assert "sigma_ms.tm" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"rotation_ms", "setup_s"}


def test_the_traced_pass_counts_a_local_sigma_an_orientation():
    c = _cell(trace=True)
    driver = harness.load_module("drivers", c.traffic["driver"]).Driver(c)
    driver.setup()
    record = driver.window()
    driver.trace(record)
    counts = record["trace"]["counts"]
    assert counts["match.orientations"] == 2 * 16
    assert counts["match.local_sigma"] == counts["match.orientations"]
    assert counts["match.transforms"] == 5 * counts["match.orientations"]


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


def _fixed_sigma(original):
    # the unrotated mask's local statistics, as if the mask were spherical
    def local_inv(self, mask, n):
        return original(self, self._mask, self._mask.sum())
    return "_local_inv", local_inv


def _unrotated_normalisation(original):
    def template(self, m, mask, n):
        return original(self, m, self._mask, self._mask.sum())
    return "_template", template


def _index_shifted(original):
    def score(self, m, index):
        return original(self, m, index + 1)
    return "_score", score


@pytest.mark.parametrize("fault", [_fixed_sigma, _unrotated_normalisation,
                                   _index_shifted])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, fault):
    name = {_fixed_sigma: "_local_inv", _unrotated_normalisation: "_template",
            _index_shifted: "_score"}[fault]
    attr, broken = fault(getattr(matching.TemplateMatcher, name))
    monkeypatch.setattr(matching.TemplateMatcher, attr, broken)
    line = harness.run_cell(_cell(), time.perf_counter())
    assert not line["correct"] and line["failed"] == 1


def test_the_roofline_count_at_the_tomogram():
    n_bytes, flops = roofline.orientation_work((256, 512, 512))
    spectrum = 256 * 512 * 257 * 8
    voxels = 256 * 512 * 512
    # two spectra read, the score and index maps read and written
    assert n_bytes == 2 * spectrum + 4 * 4 * voxels
    assert n_bytes == pytest.approx(1.6127e9, rel=1e-4)
    assert flops == 5 * 2.5 * voxels * 26
    ms, bound = roofline.orientation_ms((256, 512, 512))
    assert bound == "bytes"
    assert ms == pytest.approx(n_bytes / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.4814, abs=5e-4)

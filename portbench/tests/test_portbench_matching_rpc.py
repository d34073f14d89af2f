"""The template-matching cell with the random-phase correction
(``tm1024-rpc-match``) at a size a CPU test holds: its files load as the
deployment states (tm512's at twice the scale, the correction on), a run
is correct, its control and its faults are not, a program without the
option is refused before any data is made, and the roofline counts of
``roofline/matching_rpc.py`` are the hand-worked ones."""

import time

import pytest
import torch

from portbench import control, harness, traffic
from portbench.roofline import matching_rpc as roofline
from portbench.tests import _small  # noqa: F401  (the tests' thread count)
from voltools_tpu_torch.models import matching

CELL = "tm1024-rpc-match"
SMALL = {"shape": [24, 40, 36], "template_box": 12, "copies": 3,
         "mask": {"radius": 5.0, "edge_sigma": 1.0},
         "phantom": {"blobs": 6, "sigma": [1.0, 3.0], "region": [0.3, 0.7]},
         "template": {"blobs": 4, "sigma": [1.0, 2.0], "region": [0.3, 0.7]}}
MAPS = ("max_rel_err", "noise_max_rel_err", "corrected_max_rel_err")


def _cell(trace=False, seed=2 ** 31 + 77):
    c = harness.make_cell(CELL, seed, 0.5, trace, "cpu",
                          config_overrides=SMALL)
    c.traffic["warmup_s"] = 0.2
    c.traffic["replay"]["calls"] = 2
    return c


def _driver(trace=False):
    c = _cell(trace)
    return harness.load_module("drivers", c.traffic["driver"]).Driver(c)


def test_the_files_load_as_the_deployment_states():
    c = harness.make_cell(CELL, 1, 1, False, "cpu")
    tm512 = harness.make_cell("tm512-match", 1, 1, False, "cpu")
    differ = {k for k in c.config.keys() | tm512.config.keys()
              if c.config.get(k) != tm512.config.get(k)}
    assert differ == {"source", "deployment", "search", "shape",
                      "template_box", "template", "mask", "rotations",
                      "phantom", "random_phase_correction", "rng_seed",
                      "assumed"}
    cfg, base = c.config, tm512.config
    # bin 4: every size of tm512's doubled, every count and share kept
    assert cfg["shape"] == [2 * s for s in base["shape"]]
    assert cfg["template_box"] == 2 * base["template_box"]
    assert cfg["mask"] == {k: 2 * v for k, v in base["mask"].items()}
    for key in ("template", "phantom"):
        assert cfg[key]["sigma"] == [2 * s for s in base[key]["sigma"]]
        assert cfg[key]["blobs"] == base[key]["blobs"]
        assert cfg[key]["region"] == base[key]["region"]
    assert cfg["random_phase_correction"] is True and cfg["rng_seed"] == 321
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    assert c.traffic["driver"] == "template_match_rpc"
    assert c.traffic["orientations_per_call"] == 16
    assert set(c.limits) == set(MAPS) | {"index_mismatch"}
    assert all(c.limits[k] == tm512.limits["max_rel_err"] for k in MAPS)
    assert c.limits["index_mismatch"] == 0.0


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(trace):
    line = harness.run_cell(_cell(trace), time.perf_counter())
    assert line["correct"] and line["failed"] == 0
    assert set(line["checks"]) == set(MAPS) | {"index_mismatch"}
    assert line["checks"]["index_mismatch"]["value"] == 0
    assert all(line["checks"][k]["value"] < 1e-4 for k in MAPS)
    assert line["attempted"] % 16 == 0 and line["attempted"] >= 16
    if trace:
        # the counters count on the CPU; the device spans need the card
        assert line["metrics"]["transforms.tm"]["value"] == 4.0
        assert "noise_ms.tm" not in line["metrics"]
        assert "noise_update_roofline.tm" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"rotation_ms", "setup_s"}


def test_the_traced_pass_counts_a_noise_template_an_orientation():
    driver = _driver(trace=True)
    driver.setup()
    record = driver.window()
    driver.trace(record)
    counts = record["trace"]["counts"]
    assert counts["match.orientations"] == 2 * 16
    assert counts["match.random_phase"] == counts["match.orientations"]
    assert counts["match.transforms"] == 4 * counts["match.orientations"]


def test_the_bfloat16_control_fails_the_limit():
    driver = _driver()
    driver.setup()
    driver.window()
    driver.release()
    read = control.readings(driver, torch.bfloat16)
    limit = driver.cell.limits["max_rel_err"]
    assert read["program"]["max_rel_err"] < limit
    assert read["control"]["max_rel_err"] > 10 * limit


def _another_seed(monkeypatch):
    original = matching.phase_randomize_template
    monkeypatch.setattr(matching, "phase_randomize_template",
                        lambda template, seed: original(template, seed + 1))


def _not_subtracted(monkeypatch):
    original = matching.TemplateMatcher.result

    def result(self, output=None):
        noise, self.noise = self.noise, None
        try:
            return original(self, output)
        finally:
            self.noise = noise
    monkeypatch.setattr(matching.TemplateMatcher, "result", result)


def _noise_unrotated(monkeypatch):
    original = matching.TemplateMatcher._template

    def template(self, m, mask=None, n=None, sv=None):
        if sv is not None:
            m = torch.eye(4).numpy()
        return original(self, m, mask, n, sv)
    monkeypatch.setattr(matching.TemplateMatcher, "_template", template)


def _index_shifted(monkeypatch):
    original = matching.TemplateMatcher._score
    monkeypatch.setattr(matching.TemplateMatcher, "_score",
                        lambda self, m, index: original(self, m, index + 1))


@pytest.mark.parametrize("fault", [_another_seed, _not_subtracted,
                                   _noise_unrotated, _index_shifted])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = harness.run_cell(_cell(), time.perf_counter())
    assert not line["correct"] and line["failed"] == 1


def test_a_program_without_the_option_is_refused_before_any_data(
        monkeypatch):
    module = harness.load_module("drivers", "template_match_rpc")

    class Parent:
        def __init__(self, tomogram, template, mask, *, tilt_range=None,
                     tilt_axis=2, projection_axis=0,
                     interpolation="filt_bspline", device=None):
            raise AssertionError("never made")

    made = []
    monkeypatch.setattr(module, "TemplateMatcher", Parent)
    monkeypatch.setattr(traffic, "blob_phantom",
                        lambda *a, **k: made.append(a))
    c = _cell()
    with pytest.raises(TypeError, match="random_phase_correction"):
        module.Driver(c).setup()
    assert made == []


def test_the_roofline_counts_at_the_tomogram():
    shape = (512, 1024, 1024)
    voxels = 512 * 1024 * 1024
    spectrum = 512 * 1024 * 513 * 8
    n_bytes, flops = roofline.orientation_work(shape)
    # the spectrum and 1 / sigma read, the score, index and noise maps
    # read and written
    assert n_bytes == spectrum + 4 * voxels + 2 * 3 * 4 * voxels
    assert n_bytes == 17_184_063_488
    assert flops == 4 * 2.5 * voxels * 29
    ms, bound = roofline.orientation_ms(shape)
    assert bound == "bytes"
    assert ms == pytest.approx(n_bytes / 3.35e12 * 1e3)
    assert ms == pytest.approx(5.1296, abs=5e-4)
    ms, bound = roofline.noise_update_ms(shape)
    assert bound == "bytes"
    assert ms == pytest.approx(12 * voxels / 3.35e12 * 1e3)
    assert ms == pytest.approx(1.9231, abs=5e-4)

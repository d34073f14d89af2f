"""Each cell at a size that a CPU test can hold: the port's plain
versions on the CPU, the same harness, drivers and reference."""

import torch

SHAPES = {"rot250-cubic": [24, 28, 20], "rot250-linear": [24, 28, 20],
          "tomo512-sirt": [16, 32, 24], "tomo512-wbp": [8, 16, 12]}
SECONDS = {"tomo512-wbp": 3.0}     # 200 calls or more, for call_p95_ms
ITERATIONS = 4                      # SIRT's, on the CPU


def cell(name, seed=20251018):
    from portbench import harness
    c = harness.make_cell(name, seed, SECONDS.get(name, 0.5), False, "cpu",
                          config_overrides={"shape": SHAPES[name]})
    if "iterations" in c.traffic:
        c.traffic["iterations"] = ITERATIONS
    return c


def driven(name, seed=20251018):
    """A driver of the small cell, set up, its window run, released."""
    from portbench import harness
    c = cell(name, seed)
    driver = harness.load_module("drivers", c.traffic["driver"]).Driver(c)
    driver.setup()
    driver.window()
    driver.release()
    return driver


torch.set_num_threads(min(4, torch.get_num_threads()))

"""Every file the benchmark finds by name loads, and BENCHMARK.json keeps
to its contract's shapes and characters."""

import json
import math
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    names = [m["name"] for m in METRICS] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text
        assert "\t" not in text
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    entry = harness.workload(BENCH, cell)
    assert entry["chips"] == 1
    c = harness.make_cell(cell, 1, 1, False, "cpu")
    assert c.config["reduced"] == [] and "assumed" in c.config
    assert harness.load_module("drivers", c.traffic["driver"]).Driver
    assert 0 < c.limits["max_rel_err"] < 1
    for key in ("setup_s",):
        assert any(m["name"] == key and harness.applies(m, cell)
                   for m in BENCH["end_to_end"])
    e2e = [m for m in BENCH["end_to_end"] if harness.applies(m, cell)]
    per = [m for m in BENCH["per_layer"] if harness.applies(m, cell)]
    assert len(e2e) >= 2 and per
    e2e_names = {m["name"] for m in e2e}
    for m in per:
        assert m["moves"] in e2e_names


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_each_metric_has_a_reader(metric):
    assert callable(harness.load_module("metrics", metric).read)
    # a reader that finds nothing to read returns nothing
    assert harness.load_module("metrics", metric).read(
        {"completed": 0, "window_s": 1.0}) is None


def test_metric_fields():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for w in m.get("workloads", []):
            assert w in CELLS
        if m["name"].split(".")[0].endswith("roofline"):
            assert m["unit"] == "%"


def test_config_files_are_their_configs():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert math.isfinite(BENCH["run_seconds"])

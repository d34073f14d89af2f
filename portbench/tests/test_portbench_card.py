"""One short run of each cell on the card: the result line parses and
``correct`` is true.  Skipped without a CUDA device (decided in a
fixture); run on the card's machine with
``python -m pytest -m cuda portbench/tests/test_portbench_card.py``."""

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "2147483649", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]

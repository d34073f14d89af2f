"""What a run refuses, and what it never loads."""

import json
import os
import shutil
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def _run(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _cpu_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_run_without_a_card_fails_and_prints_no_result():
    out = _run(["portbench/run.py", "--workload", "rot250-linear", "--seed",
                "2147483659", "--seconds", "1", "--trace", "0"],
               env=_cpu_env())
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_needs_the_port(tmp_path):
    # a directory holding only BENCHMARK.json and the benchmark's files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["portbench/run.py", "--workload", "rot250-linear", "--seed",
                "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
               env=_cpu_env())
    assert out.returncode != 0 and out.stdout.strip() == ""


IMPORT_ALL = r"""
import json, sys
sys.path.insert(0, {root!r})
import portbench.run, portbench.control
from portbench import harness
bench = harness.benchmark()
for traffic in {traffics!r}:
    harness.load_module("drivers", traffic)
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.load_module("metrics", m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

IMPORT_REFERENCE = r"""
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.resample, portbench.reference.tomography
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_levels(code):
    out = _run(["-c", code], env=_cpu_env())
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    drivers = sorted(p.stem for p in (ROOT / "portbench/drivers").glob(
        "*.py") if not p.stem.startswith("_"))
    tops = _top_levels(IMPORT_ALL.format(root=str(ROOT), traffics=drivers))
    # whole top-level names: voltools_tpu_torch is the port, not
    # voltools_tpu
    assert "voltools_tpu_torch" in tops
    assert not tops & harness.FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    tops = _top_levels(IMPORT_REFERENCE.format(root=str(ROOT)))
    assert not tops & (harness.FORBIDDEN | {"voltools_tpu_torch"})

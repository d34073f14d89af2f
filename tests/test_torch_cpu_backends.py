"""The port's CPU backends, ``affine(..., device='cpu',
cpu_backend='scipy'|'native')``, against the JAX package's.

Both packages hand the same arrays to the same code -- scipy, or
``affine_cpu.cpp`` built with the same flags on this host (the port's copy
of the source) -- so every comparison is bit for bit (``np.array_equal``):
the five interpolations, both modes, ``reshape`` and ``output=`` (which
these backends fill and return).  Also: the ``mode='border'`` rule, the
errors, no silent fallback to scipy, and two processes building the
library at once."""

import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys
import threading

import numpy as np

import voltools_tpu as jvt
import voltools_tpu_torch as tvt
from voltools_tpu import native as jax_native
from voltools_tpu.utils import transform_matrix
from voltools_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (13, 15, 17)
INTERPOLATIONS = tvt.AVAILABLE_INTERPOLATIONS


@pytest.fixture(scope="module")
def vol():
    return np.random.default_rng(31).random(SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def matrix():
    return transform_matrix(rotation=(23.0, -11.0, 7.0), rotation_order="sxyz",
                            translation=(0.7, -1.2, 0.4),
                            center=tuple((s - 1) / 2 for s in SHAPE))


def _both(vol, m, **kw):
    """(port's result, JAX's result) of one CPU-backend call."""
    got = tvt.affine(vol, m, device="cpu", **kw)
    want = jvt.affine(vol, m, device="cpu", **kw)
    return got, want


def test_the_source_is_the_jax_packages_byte_for_byte():
    port = native.SOURCE.read_bytes()
    jax_src = open(os.path.join(REPO, "voltools_tpu", "native",
                                "affine_cpu.cpp"), "rb").read()
    assert port.endswith(jax_src)
    header = port[:len(port) - len(jax_src)].decode()
    assert all(line.startswith("//") for line in header.splitlines())


@pytest.mark.parametrize("reshape", [False, True])
@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
def test_scipy_backend_equals_jax(vol, matrix, interpolation, reshape):
    got, want = _both(vol, matrix, interpolation=interpolation,
                      reshape=reshape, cpu_backend="scipy")
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("reshape", [False, True])
@pytest.mark.parametrize("mode", ["constant", "border"])
@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
def test_native_backend_equals_jax(vol, matrix, interpolation, mode,
                                   reshape):
    assert native.available() and jax_native.available()
    got, want = _both(vol, matrix, interpolation=interpolation, mode=mode,
                      cval=0.5, reshape=reshape, cpu_backend="native")
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("backend", ["scipy", "native"])
def test_output_is_filled_and_returned(vol, matrix, backend):
    """The JAX CPU contract: the filled array comes back (the plain torch
    path, ``cpu_backend=None``, returns None as the device paths do)."""
    want = jvt.affine(vol, matrix, "filt_bspline", device="cpu",
                      cpu_backend=backend)
    buf = np.full(SHAPE, np.nan, np.float32)
    assert tvt.affine(vol, matrix, "filt_bspline", device="cpu",
                      cpu_backend=backend, output=buf) is buf
    assert np.array_equal(buf, want)
    # reshape: the buffer takes the enlarged shape
    big = jvt.affine(vol, matrix, device="cpu", cpu_backend=backend,
                     reshape=True)
    buf = np.zeros(big.shape, np.float32)
    assert tvt.affine(vol, matrix, device="cpu", cpu_backend=backend,
                      reshape=True, output=buf) is buf
    assert np.array_equal(buf, big)
    with pytest.raises(ValueError, match="does not match result shape"):
        tvt.affine(vol, matrix, device="cpu", cpu_backend=backend,
                   output=np.zeros((1,) + SHAPE, np.float32))
    assert tvt.affine(vol, matrix, device="cpu",
                      output=np.zeros(SHAPE, np.float32)) is None


def test_native_output_checks(vol, matrix):
    for bad, match in ((np.zeros(SHAPE, np.float64), "float32"),
                       (np.zeros(SHAPE[::-1], np.float32).T,
                        "C-contiguous")):
        with pytest.raises(ValueError, match=match):
            tvt.affine(vol, matrix, device="cpu", cpu_backend="native",
                       output=bad)
        with pytest.raises(ValueError, match=match):
            jvt.affine(vol, matrix, device="cpu", cpu_backend="native",
                       output=bad)


def test_native_prefilter_equals_jax(vol):
    assert np.array_equal(native.bspline_prefilter(vol),
                          jax_native.bspline_prefilter(vol))


def test_border_mode_takes_the_native_backend(vol, matrix, monkeypatch):
    """scipy has no 'border': the call goes to the native backend, and
    without one raises JAX's error."""
    got = tvt.affine(vol, matrix, device="cpu", cpu_backend="scipy",
                     mode="border")
    assert np.array_equal(got, tvt.affine(vol, matrix, device="cpu",
                                          cpu_backend="native",
                                          mode="border"))
    assert np.array_equal(got, jvt.affine(vol, matrix, device="cpu",
                                          mode="border"))
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(ValueError, match="requires the native backend"):
        tvt.affine(vol, matrix, device="cpu", cpu_backend="scipy",
                   mode="border")


def test_native_without_a_library_raises(vol, matrix, monkeypatch):
    """No fallback to scipy: a backend that cannot build raises."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_ERROR", OSError("no g++"))
    assert not native.available()
    with pytest.raises(RuntimeError, match="native backend unavailable"):
        tvt.affine(vol, matrix, device="cpu", cpu_backend="native")


def test_backend_names_and_devices(vol, matrix):
    with pytest.raises(ValueError, match="cpu_backend must be 'scipy' or "
                                         "'native', got 'numba'"):
        tvt.affine(vol, matrix, device="cpu", cpu_backend="numba")
    with pytest.raises(ValueError, match="cpu_backend must be"):
        jvt.affine(vol, matrix, device="cpu", cpu_backend="numba")
    with pytest.raises(ValueError, match="output='device'"):
        tvt.affine(vol, matrix, device="cpu", cpu_backend="scipy",
                   output="device")
    # a tensor volume takes the host path too
    got = tvt.affine(torch.from_numpy(vol), matrix, device="cpu",
                     cpu_backend="native")
    assert np.array_equal(got, tvt.affine(vol, matrix, device="cpu",
                                          cpu_backend="native"))


BUILD_SNIPPET = """
import sys
from pathlib import Path
from voltools_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
assert native.available(), native._BUILD_ERROR
print(native.library_path())
"""


def test_two_processes_build_the_library_at_once(tmp_path):
    """Each builds under a private name and renames it into place: both
    load a whole library, one file remains, no partial file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SNIPPET,
                               str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths.pop())]


def test_two_threads_build_at_once(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    built, errors = [], []

    def run():
        try:
            built.append(native.build())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(set(built)) == 1 and built[0].parent == tmp_path
    assert os.listdir(tmp_path) == [built[0].name]

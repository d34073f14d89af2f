"""The CUDA affine kernel's wrapper, as far as a host without a card reaches.

``voltools_tpu_torch.kernels.affine_resample.affine_resample`` launches
``csrc/affine_resample.cu`` for CUDA tensors and runs its plain torch
version for CPU tensors.  Here (no card, no nvcc) the tests check the
wrapper's routing, argument checks, launch counter, batch and into-buffer
semantics, that nothing is built at import, and that the plain version
agrees with the TPU kernel it stands in for -- the JAX package's plane-walk
Pallas kernel, run in interpret mode as ``tests/test_walk.py`` runs it,
at atol 5e-5 off knife edges.  The kernel itself is held against the plain
version on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys

import numpy as np

from voltools_tpu.kernels.pallas_walk import (affine_sample_pallas_walk,
                                              choose_walk_variant)
from voltools_tpu.utils import transform_matrix
from voltools_tpu_torch.kernels import _build
from voltools_tpu_torch.kernels import affine_resample as kernel_module
from voltools_tpu_torch.kernels.affine_resample import affine_resample
from voltools_tpu_torch.ops.sampling import affine_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def knife_edge_mask(m, shape, tol=1e-4):
    """True where any source coordinate is within ``tol`` of an integer."""
    idx = np.indices(shape, dtype=np.float64).reshape(3, -1)
    src = (np.asarray(m)[:3, :3] @ idx + np.asarray(m)[:3, 3:4])
    near = np.abs(src - np.round(src)) < tol
    return near.any(axis=0).reshape(shape)


def random_rotation(seed, shape):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-180, 180, 3)
    return transform_matrix(rotation=tuple(ang), rotation_order="sxyz",
                            center=tuple(s / 2 for s in shape))


@pytest.fixture
def volume():
    return torch.from_numpy(
        np.random.default_rng(5).random((12, 13, 14)).astype(np.float32))


@pytest.fixture
def mats():
    return torch.from_numpy(np.stack([
        random_rotation(s, (12, 13, 14)) for s in range(3)]).astype(np.float32))


@pytest.mark.parametrize("mode", ["constant", "border"])
@pytest.mark.parametrize("order,interpolation", [(1, "linear"),
                                                 (3, "bspline")])
def test_cpu_tensors_run_the_plain_version(volume, mats, order,
                                           interpolation, mode):
    before = affine_resample.launches
    got = affine_resample(volume, mats[0], order, mode, 1.5)
    want = affine_sample(volume, mats[0], interpolation, mode, 1.5,
                         prefiltered=True)
    assert torch.equal(got, want)
    assert affine_resample.launches == before, "the CPU path launches nothing"


def test_batch_matches_single_launches(volume, mats):
    batch = affine_resample(volume, mats, 3, "constant", 0.5)
    assert batch.shape == (3, 12, 13, 14)
    for i in range(3):
        assert torch.equal(batch[i],
                           affine_resample(volume, mats[i], 3, "constant", 0.5))


def test_out_buffer_is_written_in_place(volume, mats):
    out = torch.full((12, 13, 14), -7.0)
    result = affine_resample(volume, mats[1], 1, out=out)
    assert result is out
    assert torch.equal(out, affine_resample(volume, mats[1], 1))
    stack = torch.empty((3, 12, 13, 14))
    assert affine_resample(volume, mats, 1, out=stack) is stack
    assert torch.equal(stack, affine_resample(volume, mats, 1))


def test_out_shape(volume, mats):
    got = affine_resample(volume, mats, 1, out_shape=(5, 6, 20))
    assert got.shape == (3, 5, 6, 20)
    want = affine_sample(volume, mats[2], "linear", out_shape=(5, 6, 20))
    assert torch.equal(got[2], want)


def _bad_arguments(volume, mats):
    return {
        "float64 volume": dict(volume=volume.double()),
        "int matrices": dict(matrices=mats[0].int()),
        "2-D volume": dict(volume=volume[0]),
        "empty volume": dict(volume=volume[:0]),
        "(3, 4) matrix": dict(matrices=mats[0, :3].contiguous()),
        "(N, 3, 4) matrices": dict(matrices=mats[:, :3].contiguous()),
        "non-contiguous volume": dict(volume=volume.transpose(0, 2)),
        "non-contiguous matrices": dict(matrices=mats[0].t()),
        "numpy volume": dict(volume=volume.numpy()),
        "order 2": dict(order=2),
        "mode wrap": dict(mode="wrap"),
        "bad out_shape": dict(out_shape=(4, 0, 4)),
        "out wrong shape": dict(out=torch.empty((12, 13, 15))),
        "out wrong dtype": dict(out=torch.empty((12, 13, 14),
                                                dtype=torch.float64)),
        "out non-contiguous": dict(out=torch.empty((14, 13, 12)).transpose(
            0, 2)),
        "out aliases volume": dict(out=volume),
        "meta tensors": dict(volume=volume.to("meta"),
                             matrices=mats[0].to("meta")),
    }


BAD_CASES = list(_bad_arguments(torch.zeros((2, 2, 2)),
                                torch.zeros((3, 4, 4))))


@pytest.mark.parametrize("case", BAD_CASES)
def test_rejects_bad_arguments(volume, mats, case):
    kwargs = dict(volume=volume, matrices=mats[0], order=1, mode="constant")
    kwargs.update(_bad_arguments(volume, mats)[case])
    before = affine_resample.launches
    with pytest.raises((ValueError, TypeError)):
        affine_resample(**kwargs)
    assert affine_resample.launches == before


def test_cuda_source_and_build_settings():
    source = os.path.join(REPO, kernel_module.SOURCE)
    assert os.path.isfile(source)
    assert os.path.samefile(source, _build.CSRC_DIR / "affine_resample.cu")
    text = open(source).read()
    assert 'extern "C" int affine_resample_launch' in text
    assert "torch/extension.h" not in text
    assert "pallas_walk.py::_make_walk_kernel" in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path("affine_resample")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    # the build directory is ignored by git: nothing built is committed
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "voltools_tpu_torch/_build/" in f.read().split()


def test_nothing_is_built_or_loaded_at_import():
    code = (
        "import sys, subprocess\n"
        "calls = []\n"
        "real = subprocess.run\n"
        "subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)\n"
        "import voltools_tpu_torch\n"
        "from voltools_tpu_torch.kernels import _build, affine_resample as k\n"
        "assert not calls, calls\n"
        "assert not _build._LOADED\n"
        "assert k._library.cache_info().currsize == 0\n"
        "assert 'triton' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("interpolation,seed", [("linear", 0),
                                                ("bspline", 1)])
def test_plain_version_matches_tpu_walk_kernel(interpolation, seed):
    """The TPU kernel this one replaces, in interpret mode, on the shape and
    rotations of ``tests/test_walk.py``."""
    shape = (40, 48, 56)
    vol = np.random.default_rng(5).random(shape).astype(np.float32)
    m = random_rotation(seed, shape)
    v = choose_walk_variant(m, shape, interpolation, "constant")
    assert v is not None
    want = np.asarray(affine_sample_pallas_walk(vol, m, v, 0.0,
                                                interpret=True))
    order = 1 if interpolation == "linear" else 3
    got = affine_resample(torch.from_numpy(vol),
                          torch.from_numpy(m.astype(np.float32)), order).numpy()
    err = np.where(knife_edge_mask(m, shape), 0.0, np.abs(got - want))
    assert err.max() <= 5e-5, f"max err {err.max():.2e} off knife edges"

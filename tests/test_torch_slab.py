"""The slab kernel's wrapper, as far as a host without a card reaches.

``voltools_tpu_torch.kernels.affine_slab.affine_slab`` launches
``csrc/affine_slab.cu`` for CUDA tensors and runs the kernels' plain torch
version for CPU tensors.  Here (no card, no nvcc) the tests check the
wrapper's routing, its argument and plan checks, the launch counter, that
nothing is built at import, that the build hash covers the shared header,
that the public API dispatches through the planner, and that the plain
version agrees with the TPU kernel it stands in for -- the JAX package's
select-tree Pallas kernel, run in interpret mode as ``tests/test_pallas.py``
runs it, at atol 5e-5 off knife edges (interpret mode can floor a knife-edge
coordinate differently in the window origin and in the taps).  The kernel
itself is held against the plain version and the walk kernel on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import os
import shutil
import subprocess
import sys

import numpy as np

import voltools_tpu_torch as tvt
from voltools_tpu.kernels.pallas_affine import (_tree_runner,
                                                affine_sample_pallas_variant,
                                                choose_variant)
from voltools_tpu_torch.kernels import _build
from voltools_tpu_torch.kernels import affine_slab as slab_module
from voltools_tpu_torch.kernels.affine_resample import affine_resample
from voltools_tpu_torch.kernels.affine_slab import affine_slab, overflows
from voltools_tpu_torch.kernels.planner import (SlabPlan, choose_plan,
                                                slab_extents)
from voltools_tpu_torch.ops.sampling import affine_sample
from voltools_tpu_torch.utils import transform_matrix, translation_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (40, 48, 56)
CENTER = (19.5, 23.5, 27.5)
# tests/test_pallas.py's matrices
CASES = {
    "translate": translation_matrix((1.5, -2.25, 0.75)),
    "scale": transform_matrix(scale=(1.3, 0.8, 1.1), center=CENTER),
    "shear": transform_matrix(shear=(0.1, -0.05, 0.2), center=CENTER),
    "rot_z_170": transform_matrix(rotation=(170, 0, 0),
                                  rotation_order="rzxz", center=CENTER),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def knife_edge_mask(m, shape, tol=1e-4):
    """True where a source coordinate lies within ``tol`` of an integer
    (an exactly integral matrix row has no knife edge)."""
    idx = np.indices(shape, dtype=np.float64).reshape(3, -1)
    mm = np.asarray(m, np.float64)
    near = np.abs(mm[:3, :3] @ idx + mm[:3, 3:4]
                  - np.round(mm[:3, :3] @ idx + mm[:3, 3:4])) < tol
    for a in range(3):
        if (np.all(mm[a] == np.round(mm[a]))
                and np.count_nonzero(mm[a, :3]) <= 1):
            near[a] = False
    return near.any(axis=0).reshape(shape)


def assert_close_off_edges(got, want, m, atol=5e-5):
    err = np.where(knife_edge_mask(m, got.shape), 0.0, np.abs(got - want))
    assert err.max() <= atol, f"max err {err.max():.2e} off knife edges"


@pytest.fixture(scope="module")
def volume():
    return np.random.default_rng(11).random(SHAPE).astype(np.float32)


def tilts(angles=(-8.0, 3.0, 11.0)):
    return np.stack([transform_matrix(rotation=(0.0, a, 0.0),
                                      rotation_order="rzxz", center=CENTER)
                     for a in angles]).astype(np.float32)


@pytest.mark.parametrize("case,mode", [("translate", "constant"),
                                       ("scale", "border"),
                                       ("shear", "constant"),
                                       ("rot_z_170", "border")])
def test_plain_version_matches_tpu_select_tree_kernel(volume, case, mode):
    m = CASES[case]
    v = choose_variant(m, SHAPE, "linear", mode)
    assert v is not None
    want = np.asarray(affine_sample_pallas_variant(volume, m, v, 0.0,
                                                   interpret=True))
    plan = choose_plan(m, SHAPE, "linear", mode)
    assert plan is not None
    before = affine_slab.launches
    got = affine_slab(torch.from_numpy(volume),
                      torch.from_numpy(np.asarray(m, np.float32)), 1, mode,
                      plan=plan).numpy()
    assert affine_slab.launches == before, "the CPU path launches nothing"
    assert_close_off_edges(got, want, m)


def test_plain_version_matches_tpu_batched_runner(volume):
    """The grid-batched select-tree runner on a tilt sweep sharing one
    envelope, as ``tests/test_pallas.py`` runs it."""
    ms = tilts()
    v = choose_variant(ms, SHAPE, "linear", "constant")
    assert v is not None
    want = np.asarray(_tree_runner(v, 0.0, 3, True)(volume, ms))
    plan = choose_plan(ms, SHAPE, "linear")
    got = affine_slab(torch.from_numpy(volume), torch.from_numpy(ms), 1,
                      plan=plan).numpy()
    assert got.shape == (3,) + SHAPE
    for j, m in enumerate(ms):
        assert_close_off_edges(got[j], want[j], m)


@pytest.mark.parametrize("mode", ["constant", "border"])
@pytest.mark.parametrize("order,interpolation", [(1, "linear"),
                                                 (3, "bspline")])
def test_cpu_tensors_run_the_plain_version(order, interpolation, mode):
    vol = torch.from_numpy(
        np.random.default_rng(5).random((12, 13, 14)).astype(np.float32))
    ms = torch.from_numpy(tilts())
    got = affine_slab(vol, ms, order, mode, 1.5)
    for i in range(3):
        want = affine_sample(vol, ms[i], interpolation, mode, 1.5,
                             prefiltered=True)
        assert torch.equal(got[i], want)
        assert torch.equal(got[i], affine_resample(vol, ms[i], order, mode,
                                                   1.5))
    out = torch.full((3, 12, 13, 14), -7.0)
    assert affine_slab(vol, ms, order, mode, 1.5, out=out) is out
    assert torch.equal(out, got)


def test_plan_checks():
    vol = torch.rand((12, 13, 14))
    ms = torch.from_numpy(tilts())
    plan = choose_plan(ms.numpy(), (12, 13, 14), "linear")
    for bad in (SlabPlan(3, "constant", plan.vol_shape, plan.out_shape,
                         plan.extents),
                SlabPlan(1, "border", plan.vol_shape, plan.out_shape,
                         plan.extents),
                SlabPlan(1, "constant", (12, 13, 15), plan.out_shape,
                         plan.extents),
                SlabPlan(1, "constant", plan.vol_shape, plan.out_shape,
                         (1, 1, 1))):
        with pytest.raises(ValueError):
            affine_slab(vol, ms, 1, plan=bad)
    with pytest.raises(TypeError):
        affine_slab(vol, ms, 1, plan=plan.extents)
    # no plan given: one is made here, and a box that does not fit raises
    big = torch.rand((60, 60, 60))
    m = torch.from_numpy(transform_matrix(
        rotation=(45, 45, 45), rotation_order="rzxz",
        center=(29.5,) * 3).astype(np.float32))
    assert affine_slab(vol, ms, 1).shape == (3, 12, 13, 14)
    with pytest.raises(ValueError, match="cannot take"):
        affine_slab(big, m, 3)
    with pytest.raises(ValueError):
        affine_slab(vol, ms, 2)
    with pytest.raises(ValueError):
        affine_slab(vol.double(), ms, 1)
    with pytest.raises(ValueError):
        overflows("cpu")


def test_source_and_build_settings(tmp_path, monkeypatch):
    source = os.path.join(REPO, slab_module.SOURCE)
    assert os.path.samefile(source, _build.CSRC_DIR / "affine_slab.cu")
    text = open(source).read()
    assert 'extern "C" int affine_slab_launch' in text
    assert '#include "resample_taps.cuh"' in text
    assert "torch/extension.h" not in text
    assert "pallas_affine.py::_make_kernel" in text
    assert slab_module.REPLACES == "voltools_tpu/kernels/pallas_affine.py:223"
    walk_text = open(_build.CSRC_DIR / "affine_resample.cu").read()
    assert '#include "resample_taps.cuh"' in walk_text
    # a changed shared header changes both libraries' names: no stale .so
    for name in ("affine_resample.cu", "affine_slab.cu",
                 "resample_taps.cuh"):
        shutil.copy(_build.CSRC_DIR / name, tmp_path / name)
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = {n: _build.library_path(n) for n in ("affine_resample",
                                                  "affine_slab")}
    with open(tmp_path / "resample_taps.cuh", "a") as f:
        f.write("\n// changed\n")
    for n, path in before.items():
        assert _build.library_path(n) != path


def test_nothing_is_built_or_loaded_at_import():
    code = (
        "import sys, subprocess\n"
        "calls = []\n"
        "real = subprocess.run\n"
        "subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)\n"
        "import voltools_tpu_torch, voltools_tpu_torch.models\n"
        "from voltools_tpu_torch.kernels import _build, affine_slab as k\n"
        "assert not calls, calls\n"
        "assert not _build._LOADED\n"
        "assert k._library.cache_info().currsize == 0\n"
        "assert not k._OVERFLOWS\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_api_dispatches_through_the_planner():
    vol = np.random.default_rng(3).random((30, 31, 32)).astype(np.float32)
    sv = tvt.StaticVolume(vol, "linear", device="cpu")
    tilt = tilts()[0]
    sv.affine(tilt)
    info = tvt.last_dispatch()
    assert info["impl"] == "torch" and isinstance(info["variant"], SlabPlan)
    assert "slab kernel" in info["reason"]
    rot = transform_matrix(rotation=(45, 45, 45), rotation_order="rzxz",
                           center=(14.5, 15.0, 15.5))
    sv_cub = tvt.StaticVolume(vol, "bspline", device="cpu")
    sv_cub.affine(rot)
    info = tvt.last_dispatch()
    assert info["variant"] is None and "walk kernel" in info["reason"]
    extents = slab_extents(rot, vol.shape, 3)
    assert str(extents) in info["reason"]
    # a batch is planned as one envelope per chunk
    sv.affine_batch(np.stack([tilt, rot]).astype(np.float32))
    assert tvt.last_dispatch()["variant"] == choose_plan(
        np.stack([tilt, rot]), vol.shape, "linear")

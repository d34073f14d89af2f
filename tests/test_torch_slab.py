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

import voltools_tpu as jvt
import voltools_tpu_torch as tvt
from voltools_tpu.kernels.pallas_affine import (_tree_runner,
                                                affine_sample_pallas_variant,
                                                choose_variant)
from voltools_tpu_torch.kernels import _build
from voltools_tpu_torch.kernels import affine_slab as slab_module
from voltools_tpu_torch.kernels import planner
from voltools_tpu_torch.kernels.affine_resample import affine_resample
from voltools_tpu_torch.kernels.affine_slab import affine_slab, overflows
from voltools_tpu_torch.kernels.layout import (padded_width, pitched,
                                               pitched_empty, row_pitch,
                                               tma_ready)
from voltools_tpu_torch.kernels.planner import (SlabPlan, choose_plan,
                                                slab_extents, slab_plan)
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
    plan = slab_plan(m, SHAPE, "linear", mode)
    assert plan is not None
    before = _build.launches()["affine_slab"]
    got = affine_slab(torch.from_numpy(volume),
                      torch.from_numpy(np.asarray(m, np.float32)), 1, mode,
                      plan=plan).numpy()
    assert _build.launches()["affine_slab"] == before, \
        "the CPU path launches nothing"
    assert_close_off_edges(got, want, m)


def test_plain_version_matches_tpu_batched_runner(volume):
    """The grid-batched select-tree runner on a tilt sweep sharing one
    envelope, as ``tests/test_pallas.py`` runs it."""
    ms = tilts()
    v = choose_variant(ms, SHAPE, "linear", "constant")
    assert v is not None
    want = np.asarray(_tree_runner(v, 0.0, 3, True)(volume, ms))
    plan = slab_plan(ms, SHAPE, "linear")
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
    plan = slab_plan(ms.numpy(), (12, 13, 14), "linear")
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
        rotation=(45, 45, 45), rotation_order="rzxz", scale=(1.2,) * 3,
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
        "assert all(x._lib is None for x in _build._LIBRARIES)\n"
        "assert k.LIBRARY in _build._LIBRARIES\n"
        "assert not _build._COUNTERS\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_api_dispatches_through_the_planner(monkeypatch):
    vol = np.random.default_rng(3).random((30, 31, 32)).astype(np.float32)
    sv = tvt.StaticVolume(vol, "linear", device="cpu")
    tilt = tilts()[0]
    # the speed rule sends one tilt to the walk kernel, with its warp patch
    sv.affine(tilt)
    info = tvt.last_dispatch()
    assert info["impl"] == "torch" and info["variant"] is None
    assert info["rule"] == "speed" and "walk kernel" in info["reason"]
    assert "warp patch" in info["reason"]
    # where the speed rule's window holds the launch, the dispatch takes
    # the slab kernel
    monkeypatch.setitem(planner.SLAB_WINDOW, 1,
                        planner.SlabWindow(1, float("inf")))
    sv.affine(tilt)
    info = tvt.last_dispatch()
    assert info["impl"] == "torch" and isinstance(info["variant"], SlabPlan)
    assert "slab kernel" in info["reason"]
    rot = transform_matrix(rotation=(45, 45, 45), rotation_order="rzxz",
                           center=(14.5, 15.0, 15.5))
    sv.affine(rot)
    info = tvt.last_dispatch()
    assert info["variant"] is None and "walk kernel" in info["reason"]
    # the box rule's reason names the box
    extents = slab_extents(rot, vol.shape, 1)
    assert str(extents) in info["reason"] and info["rule"] == "box"
    sv_cub = tvt.StaticVolume(vol, "bspline", device="cpu")
    sv_cub.affine(rot)
    info = tvt.last_dispatch()
    assert info["variant"] is None and "walk kernel" in info["reason"]
    assert "every box size" in info["reason"]
    # a batch is planned as one envelope per chunk
    sv.affine_batch(np.stack([tilt, rot]).astype(np.float32))
    assert tvt.last_dispatch()["variant"] == choose_plan(
        np.stack([tilt, rot]), vol.shape, "linear")


def _pitched_cases(shape):
    center = tuple((s - 1) / 2 for s in shape)
    return [transform_matrix(rotation=(0, 25, 0), rotation_order="rzxz",
                             center=center),
            transform_matrix(shear=(0.1, -0.05, 0.2), center=center),
            transform_matrix(rotation=(10, 5, -3), rotation_order="rzxz",
                             center=center)]


@pytest.mark.parametrize("shape", [(10, 12, 250), (9, 11, 29), (8, 10, 32)])
@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
def test_pitched_resident_volume_matches_unpitched_and_jax(shape,
                                                           interpolation):
    """A StaticVolume keeps its volume pitched (rows a multiple of 4 floats
    apart) at widths of 4k + 2, 4k + 1 and 4k; the plain version reads the
    view and gives what it gives on the same voxels unpitched, bit for bit,
    and the JAX package's StaticVolume on the CPU to atol 5e-5 off knife
    edges."""
    vol = np.random.default_rng(shape[2]).random(shape).astype(np.float32)
    sv = tvt.StaticVolume(vol, interpolation, device="cpu")
    assert sv.data.shape == shape and tma_ready(sv.data)
    assert sv.data.stride(1) == padded_width(shape[2])
    assert sv.data.is_contiguous() == (shape[2] % 4 == 0)
    flat = sv.data.contiguous()
    jsv = jvt.StaticVolume(vol, interpolation, device="cpu")
    plain = "linear" if interpolation == "linear" else "bspline"
    for m in _pitched_cases(shape):
        got = sv.affine(m)
        want = affine_sample(flat, torch.from_numpy(m.astype(np.float32)),
                             plain, prefiltered=True).numpy()
        np.testing.assert_array_equal(got, want)
        assert_close_off_edges(got, np.asarray(jsv.affine(m)), m)


@pytest.mark.parametrize("shape", [(10, 12, 250), (9, 11, 29)])
def test_pitched_volume_matches_tpu_select_tree_kernel(shape):
    """The slab kernel's plain version on a pitched volume against the TPU
    select-tree kernel in interpret mode, as above."""
    vol = np.random.default_rng(7).random(shape).astype(np.float32)
    pvol = pitched(torch.from_numpy(vol))
    assert not pvol.is_contiguous()
    m = _pitched_cases(shape)[0]
    v = choose_variant(m, shape, "linear", "constant")
    want = np.asarray(affine_sample_pallas_variant(vol, m, v, 0.0,
                                                   interpret=True))
    got = affine_slab(pvol, torch.from_numpy(m.astype(np.float32)), 1,
                      plan=slab_plan(m, shape, "linear")).numpy()
    assert_close_off_edges(got, want, m)


def test_pitched_layout_helpers():
    vol = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(3, 4, 5)
    p = pitched(vol)
    assert p.shape == vol.shape and p.stride() == (32, 8, 1)
    assert torch.equal(p, vol) and row_pitch(p) == 8 and tma_ready(p)
    # the padding is zero and never part of the view
    assert torch.equal(p.as_strided((3, 4, 8), (32, 8, 1))[..., 5:],
                       torch.zeros(3, 4, 3))
    # an aligned volume is its own pitched form, unless a copy is asked for
    q = pitched_empty((2, 3, 8)).fill_(1.0)
    assert q.is_contiguous() and pitched(q) is q
    assert pitched(q, copy=True).data_ptr() != q.data_ptr()
    assert row_pitch(vol) == 5 and not tma_ready(vol)
    with pytest.raises(ValueError, match="row-pitched"):
        row_pitch(vol.transpose(0, 2))
    assert not tma_ready(vol.transpose(0, 2))
    assert tma_ready(pitched(vol.transpose(0, 2)))

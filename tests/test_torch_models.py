"""The port's tilt-series models against the JAX package's.

``voltools_tpu_torch.models`` -- ``TiltSeriesProjector``, ``ramp_filter``,
``wbp_reconstruct`` and ``sirt_reconstruct`` -- run on ``device='cpu'``
(the kernels' plain torch versions) and are held against
``voltools_tpu.models`` on ``device='jax'`` (XLA on the CPU), on the same
seeded inputs, handed over as numpy.  Tolerances, and why:

* projections, atol 1e-4: each sums up to 22 voxels that agree to a few
  float32 roundings, in another order;
* the ramp filter, atol 1e-6: two FFT libraries in float32 on values below
  10;
* WBP and SIRT, atol 1e-5 on results of magnitude about 1: the FFT, the
  gathers and the sums run in another order (measured differences are
  below 5e-7).

The state carried over by ``voltools_tpu_torch.convert`` and the output
contract are checked too."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np
from scipy.ndimage import gaussian_filter

import voltools_tpu.models as jm
import voltools_tpu_torch as tvt
import voltools_tpu_torch.models as tm
from voltools_tpu.models.reconstruction import _make_adjoint as jax_adjoint
from voltools_tpu_torch.convert import projector_from_state
from voltools_tpu_torch.kernels import backproject
from voltools_tpu_torch.kernels.planner import (SlabPlan, choose_plan,
                                                slab_plan)
from voltools_tpu_torch.models.reconstruction import _make_adjoint

SHAPE = (18, 20, 22)
ANGLES = np.arange(-60.0, 61.0, 30.0)
PROJ_ATOL = 1e-4
RAMP_ATOL = 1e-6
RECON_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vol():
    rng = np.random.default_rng(0)
    return gaussian_filter(rng.standard_normal(SHAPE), 1.6).astype(
        np.float32)


@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
@pytest.mark.parametrize("projection_axis,tilt_axis", [(0, 0), (0, 1),
                                                       (1, 0), (2, 1)])
def test_projector_matches_jax(vol, interpolation, projection_axis,
                               tilt_axis):
    jp = jm.TiltSeriesProjector(vol, interpolation,
                                projection_axis=projection_axis,
                                device="jax")
    tp = tm.TiltSeriesProjector(vol, interpolation,
                                projection_axis=projection_axis,
                                device="cpu")
    ms = tp.tilt_matrices(ANGLES, tilt_axis)
    np.testing.assert_array_equal(ms, jp.tilt_matrices(ANGLES, tilt_axis))
    got = tp.project(ANGLES, tilt_axis=tilt_axis)
    want = jp.project(ANGLES, tilt_axis=tilt_axis)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PROJ_ATOL, rtol=0)
    # the single-axis sweep is planned as one envelope: the box rule admits
    # it, and the planner's speed rule picks the kernel, or its row rule
    # the slab kernel's row path where the sweep is trilinear and leaves
    # array axis 2 alone ('rzxz' with the angle at position 0)
    interp = "linear" if interpolation == "linear" else "bspline"
    assert isinstance(slab_plan(ms, SHAPE, interp), SlabPlan)
    assert tvt.last_dispatch()["variant"] == choose_plan(ms, SHAPE, interp)
    rows = interp == "linear" and tilt_axis == 0
    assert tvt.last_dispatch()["rule"] == ("rows" if rows else "speed")


def test_projector_plans_from_the_matrices_it_is_given(vol, monkeypatch):
    """The JAX projector once froze its planning-time fits in a callable
    and served them for other matrices; the port plans every call from the
    matrices it is given, in chunks under the output budget."""
    tp = tm.TiltSeriesProjector(vol, "linear", device="cpu")
    ms_a = tp.tilt_matrices([-30.0, 15.0])
    ms_b = tp.tilt_matrices([40.0, -5.0])
    tp._project(ms_a)
    np.testing.assert_array_equal(tp._project(ms_b).numpy(),
                                  tp.project([40.0, -5.0]))
    ms_c = tp.tilt_matrices([0.0, 25.0, -25.0])
    want = np.stack([
        tvt.transform(vol, rotation=(0.0, a, 0.0), rotation_order="rzxz",
                      center=tp.center, device="cpu").sum(axis=0)
        for a in (0.0, 25.0, -25.0)])
    np.testing.assert_allclose(tp._project(ms_c).numpy(), want,
                               atol=PROJ_ATOL, rtol=0)
    # two volumes of output per launch: 3 tilts take 2 launches
    monkeypatch.setattr(tvt.StaticVolume, "_BATCH_BYTES_BUDGET",
                        2 * 4 * int(np.prod(SHAPE)))
    np.testing.assert_array_equal(tp._project(ms_c).numpy(),
                                  tp.project([0.0, 25.0, -25.0]))


def test_projector_contract(vol):
    tp = tm.TiltSeriesProjector(vol, "linear", projection_axis=-1,
                                device="cpu")
    assert tp.projection_axis == 2
    res = tp.project([10.0], output="device")
    assert isinstance(res, torch.Tensor) and res.shape == (1, 18, 20)
    with pytest.raises(ValueError):
        tp.project([10.0], output="Device")
    with pytest.raises(ValueError):
        tp.project([10.0], output=np.zeros((1, 18, 20), np.float32))
    with pytest.raises(ValueError):
        tm.TiltSeriesProjector(vol[0], device="cpu")
    with pytest.raises(ValueError):
        tm.TiltSeriesProjector(vol, "cubic", device="cpu")
    with pytest.raises(ValueError):
        tm.TiltSeriesProjector(vol, projection_axis=3, device="cpu")
    with pytest.raises(ValueError):
        tm.TiltSeriesProjector(vol, device="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="Unknown device"):
            tm.TiltSeriesProjector(vol)


@pytest.mark.parametrize("window", ["ramlak", "hamming"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_ramp_filter_matches_jax(window, axis):
    x = np.random.default_rng(1).random((5, 16, 20)).astype(np.float32)
    got = tm.ramp_filter(x, axis, window)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm.ramp_filter(x, axis, window)),
                               atol=RAMP_ATOL, rtol=0)
    with pytest.raises(ValueError):
        tm.ramp_filter(x, axis, "hann")


def _series(vol, projection_axis, tilt_axis):
    jp = jm.TiltSeriesProjector(vol, "linear",
                                projection_axis=projection_axis,
                                device="jax")
    return (np.array(jp.project(ANGLES, tilt_axis=tilt_axis)),
            jp.tilt_matrices(ANGLES, tilt_axis))


@pytest.mark.parametrize("projection_axis,tilt_axis,rowgather", [
    (0, 0, True), (0, 1, False), (1, 0, True), (2, 1, False)])
def test_wbp_matches_jax(vol, projection_axis, tilt_axis, rowgather,
                         monkeypatch):
    p, ms = _series(vol, projection_axis, tilt_axis)
    # the geometry takes the adjoint path it is meant to: the general path
    # samples each projection with the 2-D bilinear gather
    calls = []
    real = backproject._bilinear2d
    monkeypatch.setattr(backproject, "_bilinear2d",
                        lambda *a: calls.append(1) or real(*a))
    for window in ("ramlak", None):
        want = jm.wbp_reconstruct(p, ms, SHAPE, projection_axis,
                                  filter_window=window, device="jax")
        got = tm.wbp_reconstruct(p, ms, SHAPE, projection_axis,
                                 filter_window=window, device="cpu")
        assert got.shape == SHAPE and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=RECON_ATOL, rtol=0)
    assert bool(calls) != rowgather


@pytest.mark.parametrize("force_general", [False, True])
def test_adjoint_matches_jax_on_both_paths(force_general):
    shape = (18, 20, 22)
    tp = tm.TiltSeriesProjector(np.zeros(shape, np.float32), device="cpu")
    ms = tp.tilt_matrices(np.arange(-60.0, 61.0, 15.0), tilt_axis=0)
    minv = np.stack([np.linalg.inv(m) for m in ms]).astype(np.float32)
    projs = np.random.default_rng(4).random(
        (len(ms), shape[1], shape[2])).astype(np.float32)
    got = _make_adjoint(minv, [1, 2], shape, projs.shape[1:],
                        _force_general=force_general)(
        torch.from_numpy(projs), minv)
    want = jax_adjoint(minv, [1, 2], shape, projs.shape[1:],
                       _force_general=force_general)(projs, minv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("projection_axis,tilt_axis", [(0, 0), (2, 1)])
def test_sirt_matches_jax(vol, projection_axis, tilt_axis):
    p, ms = _series(vol, projection_axis, tilt_axis)
    want = jm.sirt_reconstruct(p, ms, SHAPE, iterations=3,
                               projection_axis=projection_axis, nonneg=True,
                               device="jax")
    got = tm.sirt_reconstruct(p, ms, SHAPE, iterations=3,
                              projection_axis=projection_axis, nonneg=True,
                              device="cpu")
    assert got.min() >= 0.0
    np.testing.assert_allclose(got, want, atol=RECON_ATOL, rtol=0)
    # relax and a starting volume, without the clip
    init = np.full(SHAPE, 0.1, np.float32)
    want = jm.sirt_reconstruct(p, ms, SHAPE, iterations=2, relax=0.5,
                               projection_axis=projection_axis,
                               initial=init, device="jax")
    got = tm.sirt_reconstruct(p, ms, SHAPE, iterations=2, relax=0.5,
                              projection_axis=projection_axis,
                              initial=init, device="cpu")
    np.testing.assert_allclose(got, want, atol=RECON_ATOL, rtol=0)
    # the kernels' forward and the plain forward agree on the CPU
    plain = tm.sirt_reconstruct(p, ms, SHAPE, iterations=2, relax=0.5,
                                projection_axis=projection_axis,
                                initial=init, device="cpu",
                                _plain_forward=True)
    np.testing.assert_array_equal(plain, got)


def test_reconstruct_contract(vol):
    p, ms = _series(vol, 0, 0)
    want = tm.wbp_reconstruct(p, ms, SHAPE, device="cpu")
    np.testing.assert_array_equal(
        tm.wbp_reconstruct(p, ms, SHAPE, projection_axis=-3, device="cpu"),
        want)
    buf = np.zeros(SHAPE, np.float32)
    assert tm.wbp_reconstruct(p, ms, SHAPE, device="cpu", output=buf) is None
    np.testing.assert_array_equal(buf, want)
    res = tm.wbp_reconstruct(torch.from_numpy(p), ms, SHAPE, device="cpu",
                             output="device")
    assert isinstance(res, torch.Tensor)
    np.testing.assert_array_equal(res.numpy(), want)
    sirt = tm.sirt_reconstruct(p, ms, SHAPE, iterations=1, device="cpu")
    buf = np.zeros(SHAPE, np.float32)
    assert tm.sirt_reconstruct(p, ms, SHAPE, iterations=1, device="cpu",
                               output=buf) is None
    np.testing.assert_array_equal(buf, sirt)
    for fn in (tm.wbp_reconstruct, tm.sirt_reconstruct):
        with pytest.raises(ValueError):
            fn(p, ms, SHAPE, device="cpu", output="Device")
        with pytest.raises(ValueError):
            fn(p, ms, SHAPE, projection_axis=3, device="cpu")
        with pytest.raises(ValueError):
            fn(p[0], ms[:1], SHAPE, device="cpu")
        with pytest.raises(ValueError):
            fn(p, ms[:2], SHAPE, device="cpu")
        with pytest.raises(ValueError):
            fn(p, ms, (12, 12), device="cpu")
        with pytest.raises(ValueError):
            fn(p, ms, SHAPE, device="tpu")
    with pytest.raises(ValueError):
        tm.wbp_reconstruct(p, ms, SHAPE, filter_axis=0, device="cpu")
    with pytest.raises(ValueError):
        tm.sirt_reconstruct(p, ms, SHAPE, initial=np.zeros((2, 2, 2)),
                            device="cpu")


@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
def test_convert_carries_projector_state(vol, interpolation):
    jp = jm.TiltSeriesProjector(vol, interpolation, projection_axis=1,
                                device="jax")
    tp = projector_from_state(np.asarray(jp.data), jp.shape,
                              jp.interpolation, jp.projection_axis,
                              jp.rotation_order, jp._mode, device="cpu")
    # the coefficients are carried over as they are, not filtered again
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    np.testing.assert_allclose(tp.project(ANGLES, tilt_axis=0),
                               jp.project(ANGLES, tilt_axis=0),
                               atol=PROJ_ATOL, rtol=0)
    with pytest.raises(ValueError):
        projector_from_state(np.asarray(jp.data), (1, 2, 3), interpolation,
                             device="cpu")


def test_models_are_exported():
    for name in ("TiltSeriesProjector", "ramp_filter", "wbp_reconstruct",
                 "sirt_reconstruct"):
        assert hasattr(tvt.models, name), name

"""The plain reference against scipy.ndimage at small sizes."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from portbench import traffic
from portbench.reference import resample as ref
from portbench.reference import tomography as tomo

SHAPE = (18, 22, 15)


def _volume(seed=3):
    _, gen = traffic.seeded(seed)
    return traffic.blob_phantom(SHAPE, 6, (1.5, 3.0), (0.3, 0.7),
                                gen("cpu"), "cpu").double()


def test_prefilter_is_scipys_mirror_spline_filter():
    v = np.random.default_rng(0).random((13, 17, 11))
    got = ref.prefilter(torch.tensor(v)).numpy()
    want = ndi.spline_filter(v, 3, mode="mirror")
    assert np.abs(got - want).max() < 1e-12


@pytest.mark.parametrize("interpolation,order",
                         [("linear", 1), ("filt_bspline", 3)])
def test_resample_is_scipys_affine_transform(interpolation, order):
    vol = _volume()
    rng = np.random.default_rng(4)
    for m in traffic.rotation_pool(rng, 3, SHAPE):
        got = ref.transform(vol, m, interpolation).numpy()
        want = ndi.affine_transform(vol.numpy(), m.astype(np.float64),
                                    order=order, mode="constant",
                                    prefilter=True)
        # float32 coordinates against scipy's float64 ones; the phantom is
        # zero at the edges, so no in-range test flips a value
        assert np.abs(got - want).max() < 2e-6 * np.abs(want).max()


def _series(shape=(8, 20, 12)):
    return traffic.tilt_series(np.arange(-60, 61, 15.0), shape), shape


def test_projection_is_scipys_rotation_summed():
    ms, shape = _series()
    _, gen = traffic.seeded(2)
    vol = traffic.blob_phantom(shape, 6, (1.5, 3.0), (0.3, 0.7),
                               gen("cpu"), "cpu")
    got = tomo.TiltSeries(ms, shape, "cpu").project(vol).numpy()
    want = np.stack([ndi.affine_transform(
        vol.double().numpy(), m.astype(np.float64), order=1,
        mode="constant").sum(0) for m in ms])
    assert np.abs(got - want).max() < 1e-6 * np.abs(want).max()


def test_backprojection_is_scipys_linear_sample_with_zero_taps():
    ms, shape = _series()
    projs = torch.rand((len(ms),) + shape[1:], dtype=torch.float64,
                       generator=torch.Generator().manual_seed(1))
    got = tomo.TiltSeries(ms, shape, "cpu").backproject(projs).numpy()
    z, y, x = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    want = np.zeros(shape)
    for p, m in zip(projs.numpy(), ms):
        mi = np.linalg.inv(m.astype(np.float64))
        rows = mi[1, 0] * z + mi[1, 1] * y + mi[1, 3]
        # 'grid-constant': a tap outside the projection counts 0
        want += ndi.map_coordinates(p, [rows, x], order=1,
                                    mode="grid-constant")
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_wbp_and_sirt_of_a_noiseless_series_find_the_phantom():
    ms, shape = _series((8, 24, 12))
    ms = traffic.tilt_series(np.arange(-60, 61, 3.0), shape)
    _, gen = traffic.seeded(5)
    vol = traffic.blob_phantom(shape, 4, (2.0, 3.0), (0.4, 0.6),
                               gen("cpu"), "cpu").double()
    series = tomo.TiltSeries(ms, shape, "cpu")
    projs = series.project(vol)
    for x in (tomo.sirt(series, projs, 30), tomo.wbp(series, projs)):
        assert np.corrcoef(x.flatten().numpy(),
                           vol.flatten().numpy())[0, 1] > 0.85


def test_other_geometries_are_refused():
    m = traffic.rotation_pool(np.random.default_rng(0), 2, SHAPE)
    with pytest.raises(NotImplementedError):
        tomo.TiltSeries(m, SHAPE, "cpu")

"""The generators against the port's own matrix helpers (a test may
import the port; the harness's run path builds its matrices itself)."""

import numpy as np
import torch

from portbench import traffic
from voltools_tpu_torch.utils import transform_matrix


def test_rotation_draw_is_the_reference_benchmarks():
    rng = np.random.default_rng(11)
    angles = rng.uniform(-180, 180, (6, 3))
    got = traffic.sxyz_matrices(angles, (125.0, 125.0, 125.0))
    for g, a in zip(got, angles):
        want = transform_matrix(rotation=tuple(a), rotation_order="sxyz",
                                center=(125, 125, 125))
        np.testing.assert_allclose(g, want, rtol=0, atol=6e-5)


def test_rotation_pool_is_seeded():
    seed = 2 ** 31 + 5
    a = traffic.rotation_pool(np.random.default_rng(seed), 4, (250,) * 3)
    b = traffic.rotation_pool(np.random.default_rng(seed), 4, (250,) * 3)
    assert a.dtype == np.float32 and a.shape == (4, 4, 4)
    np.testing.assert_array_equal(a, b)


def test_tilt_series_is_the_projectors():
    shape = (256, 512, 512)
    angles = np.arange(-60, 61, 3.0)
    got = traffic.tilt_series(angles, shape)
    center = np.divide(np.subtract(shape, 1), 2, dtype=np.float32)
    for g, a in zip(got, angles):
        want = transform_matrix(rotation=(a, 0, 0), rotation_order="rzxz",
                                center=center)
        np.testing.assert_allclose(g, want, rtol=0, atol=6e-5)
    # the single-axis geometry the reference takes, exactly
    assert (got[:, 2] == np.float32([0, 0, 1, 0])).all()
    assert (got[:, :2, 2] == 0).all()


def test_phantom_is_seeded_and_smooth():
    _, gen = traffic.seeded(7)
    a = traffic.blob_phantom((20, 24, 22), 5, (2, 4), (0.25, 0.75),
                             gen("cpu"), "cpu")
    _, gen = traffic.seeded(7)
    b = traffic.blob_phantom((20, 24, 22), 5, (2, 4), (0.25, 0.75),
                             gen("cpu"), "cpu")
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.max()) > 0.5
    assert float(a[0].abs().max()) < 1e-2 * float(a.max())


def test_sample_indices():
    rng = np.random.default_rng(0)
    picked = traffic.sample_indices(rng, 16, 1000)
    assert len(set(picked)) == 16 and picked == sorted(picked)
    assert 0 <= picked[0] and picked[-1] < 1000
    assert traffic.sample_indices(rng, 5, 3) == [0, 1, 2]

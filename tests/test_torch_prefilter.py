"""The PyTorch port's B-spline prefilter against the JAX package's and scipy.

Mirror (the banded-Toeplitz product) is held to the JAX package's FIR path
and to ``scipy.ndimage.spline_filter(mode='mirror')``; clamp (the exact
recursion) to the JAX package's scan, which carries the reference GPU
kernels' initialisation -- scipy has no boundary mode with that
initialisation.  Axis extents 2..16 and 40, atol 1e-5: both sides run the same
float32 arithmetic, and scipy's float64 result differs by float32 rounding
(about 1e-6 on these inputs)."""

import pytest

torch = pytest.importorskip("torch")

import functools

import jax
import numpy as np
from scipy.ndimage import spline_filter

from voltools_tpu.ops import prefilter as jax_prefilter
from voltools_tpu_torch.ops import prefilter

# every axis extent 2..16 and 40, each on some axis of some volume
SHAPES = [(2, 3, 4), (5, 6, 7), (8, 9, 10), (11, 12, 13), (14, 15, 16),
          (16, 40, 2), (40, 3, 11)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_prefilter(boundary):
    return jax.jit(functools.partial(jax_prefilter.bspline_prefilter,
                                     boundary=boundary))


@pytest.mark.parametrize("shape", SHAPES)
def test_mirror_matches_jax_and_scipy(shape):
    x = np.random.default_rng(shape[0]).random(shape).astype(np.float32)
    got = prefilter.bspline_prefilter(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(_jax_prefilter("mirror")(x)),
                               atol=1e-5)
    np.testing.assert_allclose(
        got, spline_filter(x.astype(np.float64), order=3, mode="mirror"),
        atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_clamp_matches_jax(shape):
    x = np.random.default_rng(100 + shape[0]).random(shape).astype(np.float32)
    got = prefilter.bspline_prefilter(torch.from_numpy(x), "clamp").numpy()
    np.testing.assert_allclose(got, np.asarray(_jax_prefilter("clamp")(x)),
                               atol=1e-5)


@pytest.mark.parametrize("boundary", ["mirror", "clamp"])
def test_scan_matches_jax_scan_per_axis(boundary):
    x = np.random.default_rng(7).random((3, 33, 6)).astype(np.float32)
    for axis in range(3):
        got = prefilter.prefilter_scan(torch.from_numpy(x), axis,
                                       boundary).numpy()
        want = np.asarray(jax_prefilter.prefilter_scan(x, axis, boundary))
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_fir_matches_jax_fir_per_axis():
    x = np.random.default_rng(8).random((12, 40, 9)).astype(np.float32)
    for axis in range(3):
        got = prefilter.prefilter_fir(torch.from_numpy(x), axis).numpy()
        want = np.asarray(jax_prefilter.prefilter_fir(x, axis))
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_fir_rejects_clamp_and_bad_boundary():
    x = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError):
        prefilter.prefilter_fir(x, 0, "clamp")
    with pytest.raises(ValueError):
        prefilter.bspline_prefilter(x, boundary="wrap")


def test_axes_of_one_pass_through():
    x = np.random.default_rng(9).random((1, 1, 6)).astype(np.float32)
    got = prefilter.bspline_prefilter(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_prefilter.bspline_prefilter(x)), atol=1e-5)


def test_matmul_settings_restored():
    """The product runs with TF32 off and 'highest' precision, and puts
    back whatever the caller had set."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        seen = []
        real_matmul = torch.matmul

        def spy(a, b):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.get_float32_matmul_precision()))
            return real_matmul(a, b)

        torch.matmul = spy
        try:
            prefilter.prefilter_fir(torch.rand((5, 6, 7)), 1)
        finally:
            torch.matmul = real_matmul
        assert seen == [(False, "highest")]
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])

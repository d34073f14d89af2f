"""The PyTorch port's plain sampler against the JAX package's XLA sampler.

The same seeded inputs go through ``voltools_tpu.ops.affine_sample_batch``
(jitted, on the CPU) and ``voltools_tpu_torch.ops.affine_sample_batch``:
all five interpolations, both edge modes, cval 0 and 1.5, random 'sxyz'
rotations plus a translate, a scale and a shear, on (17, 19, 23),
(40, 48, 56) and shapes with extents down to 1.

Tolerance: atol 5e-5 off knife edges, the JAX suite's own rule
(``tests/test_walk.py:52-64``): voxels whose source coordinate lies within
1e-4 of an integer are masked, because XLA:CPU may contract the coordinate
chain into FMAs where the port rounds each operation, and floor() can then
flip.  Elsewhere the two compute the same sums in float32."""

import pytest

torch = pytest.importorskip("torch")

import functools

import jax
import numpy as np

from voltools_tpu.ops import affine_sample_batch as jax_affine_sample_batch
from voltools_tpu.utils import transform_matrix
from voltools_tpu_torch import AVAILABLE_INTERPOLATIONS
from voltools_tpu_torch.ops import affine_sample, affine_sample_batch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def knife_edge_mask(m, shape, tol=1e-4):
    """True where any source coordinate is within ``tol`` of an integer.

    An axis whose matrix row is exactly integral (one integer coefficient
    and an integer offset) gives exact integer coordinates in float32 and
    has no knife edge, so it is not masked (the rule of
    ``benchmarks/tpu_parity_smoke.py::masked_err``)."""
    idx = np.indices(shape, dtype=np.float64).reshape(3, -1)
    mm = np.asarray(m, np.float64)
    src = mm[:3, :3] @ idx + mm[:3, 3:4]
    near = np.abs(src - np.round(src)) < tol
    for a in range(3):
        if (np.all(mm[a] == np.round(mm[a]))
                and np.count_nonzero(mm[a, :3]) <= 1):
            near[a] = False
    return near.any(axis=0).reshape(shape)


def assert_close_off_edges(got, want, m, atol=5e-5):
    assert got.shape == want.shape
    mask = knife_edge_mask(m, got.shape)
    assert mask.mean() < 0.5, "the mask would hide most of the comparison"
    err = np.where(mask, 0.0, np.abs(got - want))
    assert err.max() <= atol, f"max err {err.max():.2e} off knife edges"


def matrices(shape, seed):
    """Two random 'sxyz' rotations about size/2, a translate, a scale and a
    shear (non-integral, so few coordinates sit on knife edges)."""
    rng = np.random.default_rng(seed)
    center = tuple(s / 2 for s in shape)
    ms = [transform_matrix(rotation=tuple(rng.uniform(-180, 180, 3)),
                           rotation_order="sxyz", center=center)
          for _ in range(2)]
    ms.append(transform_matrix(translation=(0.37, -1.21, 2.53)))
    ms.append(transform_matrix(scale=(0.83, 1.07, 0.91), center=center))
    ms.append(transform_matrix(shear=(0.13, -0.08, 0.21), center=center))
    return np.stack(ms).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_batch(interpolation, mode):
    # cval and the matrices stay traced: one compile per shape serves both
    # cvals and every matrix
    return jax.jit(functools.partial(jax_affine_sample_batch,
                                     interpolation=interpolation, mode=mode))


def check_against_jax(vol, ms, interpolation, mode):
    for cval in (0.0, 1.5):
        want = np.asarray(_jax_batch(interpolation, mode)(vol, ms, cval=cval))
        got = affine_sample_batch(torch.from_numpy(vol), torch.from_numpy(ms),
                                  interpolation, mode, cval).numpy()
        assert got.dtype == np.float32
        for i, m in enumerate(ms):
            assert_close_off_edges(got[i], want[i], m)


@pytest.mark.parametrize("mode", ["constant", "border"])
@pytest.mark.parametrize("interpolation", AVAILABLE_INTERPOLATIONS)
def test_affine_sample_matches_jax(interpolation, mode):
    rng = np.random.default_rng(11)
    for shape in [(17, 19, 23), (40, 48, 56)]:
        vol = rng.random(shape).astype(np.float32)
        check_against_jax(vol, matrices(shape, seed=shape[0]),
                          interpolation, mode)


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 6, 7), (5, 1, 4),
                                   (3, 4, 1)])
def test_tiny_extents_match_jax(shape):
    """Extents of 1 exercise the n == 1 mirror and the skipped prefilter."""
    vol = np.random.default_rng(2).random(shape).astype(np.float32)
    ms = matrices(shape, seed=5)
    for interpolation in ("linear", "filt_bspline"):
        for mode in ("constant", "border"):
            check_against_jax(vol, ms, interpolation, mode)


def test_single_matrix_equals_batch_slice():
    vol = torch.from_numpy(
        np.random.default_rng(4).random((9, 10, 11)).astype(np.float32))
    ms = torch.from_numpy(matrices((9, 10, 11), seed=1))
    batch = affine_sample_batch(vol, ms, "filt_bspline", "border", 1.5)
    for i in range(len(ms)):
        assert torch.equal(batch[i], affine_sample(vol, ms[i], "filt_bspline",
                                                   "border", 1.5))


def test_out_shape_and_empty_batch():
    vol = torch.zeros((4, 5, 6))
    out = affine_sample(vol, np.eye(4), out_shape=(2, 3, 7))
    assert out.shape == (2, 3, 7)
    assert affine_sample_batch(vol, np.zeros((0, 4, 4))).shape == (0, 4, 5, 6)


def test_identity_is_exact_for_linear():
    vol = np.random.default_rng(6).random((6, 7, 8)).astype(np.float32)
    got = affine_sample(torch.from_numpy(vol), np.eye(4), "linear").numpy()
    np.testing.assert_array_equal(got, vol)


def test_sample_is_differentiable():
    vol = torch.rand((6, 6, 6), requires_grad=True)
    m = torch.tensor(transform_matrix(rotation=(10, 20, 30), center=(3, 3, 3)),
                     requires_grad=True)
    affine_sample(vol, m, "bspline").sum().backward()
    assert torch.isfinite(vol.grad).all() and torch.isfinite(m.grad).all()

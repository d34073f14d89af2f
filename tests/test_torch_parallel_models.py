"""The port's mesh modes of WBP and SIRT against the JAX package's.

``voltools_tpu_torch.models.wbp_reconstruct(mesh=, mesh_shard=)`` and
``sirt_reconstruct(mesh=)`` run on an 8-shard mesh on the CPU
(``make_mesh(8, device='cpu')``) and are held against the same calls of
``voltools_tpu.models`` on the 8 host devices that ``tests/conftest.py``
forces, and against the single-device reconstructions, on the same seeded
inputs handed over as numpy.  Tolerances are those of
``tests/test_models.py``'s mesh tests: WBP atol 1e-5, SIRT atol 5e-5, on
results of magnitude about 1 (the partial sums run in another order).  The
JAX side is computed once per module."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np
from scipy.ndimage import gaussian_filter

import voltools_tpu.models as jm
from voltools_tpu import parallel as jpar
import voltools_tpu_torch.models as tm
from voltools_tpu_torch.models.reconstruction import (_forward_partial,
                                                      _trilinear3d_pertap)
from voltools_tpu_torch.parallel import make_mesh

WBP_ATOL = 1e-5
SIRT_ATOL = 5e-5
ANGLES_WBP = np.arange(0.0, 180.0, 10.0)     # 18 tilts: 18 % 8 != 0
ANGLES_SIRT = np.arange(-60.0, 61.0, 15.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, device="cpu")


def _series(vol, angles, tilt_axis, projection_axis=0):
    """A JAX projector's tilt matrices and projections of ``vol``."""
    proj = jm.TiltSeriesProjector(vol, "linear",
                                  projection_axis=projection_axis,
                                  device="jax")
    return (proj.tilt_matrices(angles, tilt_axis=tilt_axis),
            proj.project(angles, tilt_axis=tilt_axis))


@pytest.fixture(scope="module")
def wbp_case():
    shape = (16, 16, 16)
    rng = np.random.default_rng(1)
    vol = gaussian_filter(rng.standard_normal(shape), 1.5).astype(np.float32)
    ms, p = _series(vol, ANGLES_WBP, 0)
    ms_o, p_o = _series(vol[:13], ANGLES_WBP, 0)
    return shape, ms, p, ms_o, p_o


@pytest.mark.parametrize("mesh_shard", ["tilts", "volume"])
def test_wbp_mesh_matches_jax(jmesh, mesh, wbp_case, mesh_shard):
    """Tilt-sharded WBP (partial volumes summed, the 18-tilt batch padded
    with zero projections) and output-sharded WBP (a z slab per shard)
    equal the JAX package's mesh call and the single-device call."""
    shape, ms, p, _, _ = wbp_case
    got = tm.wbp_reconstruct(p, ms, shape, mesh=mesh, mesh_shard=mesh_shard)
    assert isinstance(got, np.ndarray) and got.shape == shape
    want = jm.wbp_reconstruct(p, ms, shape, mesh=jmesh,
                              mesh_shard=mesh_shard)
    np.testing.assert_allclose(got, want, atol=WBP_ATOL, rtol=0)
    single = tm.wbp_reconstruct(p, ms, shape, device="cpu")
    np.testing.assert_allclose(got, single, atol=WBP_ATOL, rtol=0)


def test_wbp_mesh_volume_odd_extent(jmesh, mesh, wbp_case):
    """A z extent that does not divide the mesh (13 over 8 shards: slabs
    of 2, three of them wholly in the pad) is padded and cropped."""
    shape, _, _, ms_o, p_o = wbp_case
    shape_o = (13,) + shape[1:]
    got = tm.wbp_reconstruct(p_o, ms_o, shape_o, mesh=mesh,
                             mesh_shard="volume")
    want = jm.wbp_reconstruct(p_o, ms_o, shape_o, mesh=jmesh,
                              mesh_shard="volume")
    np.testing.assert_allclose(got, want, atol=WBP_ATOL, rtol=0)
    single = jm.wbp_reconstruct(p_o, ms_o, shape_o, device="jax")
    np.testing.assert_allclose(got, single, atol=WBP_ATOL, rtol=0)
    slabs = tm.wbp_reconstruct(p_o, ms_o, shape_o, mesh=mesh,
                               mesh_shard="volume", output="device")
    assert [s.shape[0] for s in slabs] == [2] * 6 + [1]
    np.testing.assert_array_equal(torch.cat(slabs).numpy(), got)


def test_wbp_mesh_contract(mesh, wbp_case):
    shape, ms, p, _, _ = wbp_case
    with pytest.raises(ValueError, match="mesh_shard"):
        tm.wbp_reconstruct(p, ms, shape, mesh=mesh, mesh_shard="rows")
    # the replicated result is one tensor on the first shard's device
    res = tm.wbp_reconstruct(p, ms, shape, mesh=mesh, output="device")
    assert isinstance(res, torch.Tensor) and res.shape == shape
    buf = np.empty(shape, np.float32)
    assert tm.wbp_reconstruct(p, ms, shape, mesh=mesh, mesh_shard="volume",
                              output=buf) is None
    np.testing.assert_allclose(buf, res.numpy(), atol=WBP_ATOL, rtol=0)
    with pytest.raises(ValueError, match="output"):
        tm.wbp_reconstruct(p, ms, shape, mesh=mesh, mesh_shard="volume",
                           output="host")


@pytest.fixture(scope="module")
def sirt_vol():
    rng = np.random.default_rng(3)
    return gaussian_filter(rng.standard_normal((24, 20, 20)),
                           2.0).astype(np.float32)


def test_sirt_mesh_matches_jax(jmesh, mesh, sirt_vol):
    """Volume-sharded SIRT (per-slab forward summed over the shards,
    slab-offset adjoint) equals the JAX package's mesh call and the
    single-device SIRT."""
    shape = sirt_vol.shape
    ms, p = _series(sirt_vol, ANGLES_SIRT, 0)
    got = tm.sirt_reconstruct(p, ms, shape, iterations=5, mesh=mesh)
    want = jm.sirt_reconstruct(p, ms, shape, iterations=5, mesh=jmesh)
    np.testing.assert_allclose(got, want, atol=SIRT_ATOL, rtol=0)
    single = tm.sirt_reconstruct(p, ms, shape, iterations=5, device="cpu")
    np.testing.assert_allclose(got, single, atol=SIRT_ATOL, rtol=0)


def test_sirt_mesh_odd_extent_nonneg(jmesh, mesh, sirt_vol):
    """An odd z extent (23 over 8 shards: padded slabs), tilt axis 1 and
    the non-negative projection, against the JAX package's mesh call and
    the single-device SIRT."""
    vol = sirt_vol[:23]
    shape = vol.shape
    ms, p = _series(vol, ANGLES_SIRT, 1)
    got = tm.sirt_reconstruct(p, ms, shape, iterations=4, nonneg=True,
                              mesh=mesh)
    assert got.min() >= 0
    want = jm.sirt_reconstruct(p, ms, shape, iterations=4, nonneg=True,
                               mesh=jmesh)
    np.testing.assert_allclose(got, want, atol=SIRT_ATOL, rtol=0)
    single = jm.sirt_reconstruct(p, ms, shape, iterations=4, nonneg=True,
                                 device="jax")
    np.testing.assert_allclose(got, single, atol=SIRT_ATOL, rtol=0)


def test_sirt_mesh_projection_axis_1(jmesh, mesh, sirt_vol):
    """Projection along axis 1 (the forward sums planes of y, the slabs
    stay z slabs), with a starting volume, against the single-device
    SIRT of both packages."""
    shape = sirt_vol.shape
    ms, p = _series(sirt_vol, ANGLES_SIRT, 0, projection_axis=1)
    initial = np.full(shape, 0.1, np.float32)
    got = tm.sirt_reconstruct(p, ms, shape, iterations=3, projection_axis=1,
                              initial=initial, mesh=mesh)
    want = jm.sirt_reconstruct(p, ms, shape, iterations=3,
                               projection_axis=1, initial=initial,
                               device="jax")
    np.testing.assert_allclose(got, want, atol=SIRT_ATOL, rtol=0)
    single = tm.sirt_reconstruct(p, ms, shape, iterations=3,
                                 projection_axis=1, initial=initial,
                                 device="cpu")
    np.testing.assert_allclose(got, single, atol=SIRT_ATOL, rtol=0)
    slabs = tm.sirt_reconstruct(p, ms, shape, iterations=3,
                                projection_axis=1, initial=initial,
                                mesh=mesh, output="device")
    assert len(slabs) == 8
    np.testing.assert_array_equal(torch.cat(slabs).numpy(), got)
    with pytest.raises(ValueError, match="initial"):
        tm.sirt_reconstruct(p, ms, shape, iterations=1, mesh=mesh,
                            initial=initial[:20])


def test_trilinear_pertap_matches_jax():
    """The per-tap zero-extended trilinear sample against the JAX
    package's, on points inside, across and outside a block."""
    from voltools_tpu.models.reconstruction import \
        _trilinear3d_pertap as jax_pertap
    rng = np.random.default_rng(4)
    vol = rng.random((5, 7, 6)).astype(np.float32)
    pts = rng.uniform(-2.0, 8.0, (3, 4, 9, 11)).astype(np.float32)
    got = _trilinear3d_pertap(torch.from_numpy(vol),
                              *torch.from_numpy(pts))
    want = np.asarray(jax_pertap(vol, *pts))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_forward_partials_sum_to_the_forward(sirt_vol):
    """The slabs' partial projections sum to the single-device projector
    (per-tap zero extension is exact), and a slab far from every tilt's
    source adds nothing."""
    shape = sirt_vol.shape
    proj = tm.TiltSeriesProjector(sirt_vol, "linear", device="cpu")
    ms = proj.tilt_matrices(ANGLES_SIRT, tilt_axis=0)
    want = proj.project(ANGLES_SIRT, tilt_axis=0)
    vol = torch.from_numpy(sirt_vol)
    for local in (5, 8, 24):
        total = sum(_forward_partial(vol[z:z + local].contiguous(), ms,
                                     float(z), shape, 0)
                    for z in range(0, shape[0], local))
        np.testing.assert_allclose(total.numpy(), want, atol=1e-4, rtol=0)
    far = _forward_partial(torch.ones((4,) + shape[1:]), ms[4:5], 200.0,
                           shape, 0)
    assert not far.any()

"""The port's sharded volume and data-parallel batch against the JAX
package's.

``voltools_tpu_torch.parallel`` runs on an 8-shard mesh on the CPU
(``make_mesh(8, device='cpu')``: the kernels' plain versions), and is held
against ``voltools_tpu.parallel`` on the 8 host devices that
``tests/conftest.py`` forces, on the same seeded inputs handed over as
numpy.  Each test mirrors one of ``tests/test_parallel.py``, with its
tolerance: atol 3e-5 where the JAX test holds its sharded call to the
single-device one, 5e-4 off knife edges for full 3-D rotations and padded
extents (``_knife_mask``), 2e-5 for the sharded prefilter.  The JAX side of
each comparison is computed once per module."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

import voltools_tpu as jvt
from voltools_tpu import parallel as jpar
from voltools_tpu.ops.sampling import affine_sample as jax_affine_sample
from voltools_tpu.utils import (rotation_matrix, transform_matrix,
                                translation_matrix)
from voltools_tpu_torch import StaticVolume, last_dispatch
from voltools_tpu_torch.convert import sharded_from_state
from voltools_tpu_torch.parallel import (Mesh, ShardedVolume,
                                         halo_for_matrix, make_mesh,
                                         sharded_affine_batch)
from voltools_tpu_torch.parallel.sharded import _crop

ATOL = 3e-5          # a sharded call against the single-device one
KNIFE_ATOL = 5e-4    # full 3-D rotations and padded extents, off knife edges
PREFILTER_ATOL = 2e-5


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


@pytest.fixture(scope="module")
def volume():
    rng = np.random.default_rng(99)
    return rng.random((64, 24, 24)).astype(np.float32)


def _center(shape):
    return np.divide(np.subtract(shape, 1), 2)


def _knife_mask(m, shape, tol=1e-4):
    """Near-integer and near-half-integer (the border discard band) source
    coordinates, where independent float32 evaluations may disagree by an
    ulp (``tests/test_parallel.py:175-183``)."""
    idx = np.indices(shape, dtype=np.float64).reshape(3, -1)
    src = np.asarray(m, np.float64)[:3, :3] @ idx + \
        np.asarray(m, np.float64)[:3, 3:4]
    near = np.abs(src - np.round(src)) < tol
    near |= np.abs(src - np.round(src + 0.5) + 0.5) < tol
    return near.any(axis=0).reshape(shape)


def _off_knife(got, want, m):
    err = np.abs(got - want)
    err[_knife_mask(m, got.shape)] = 0
    return err.max()


class DispatchShapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns while active."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


LOCAL_M = transform_matrix(translation=(1.3, -0.8, 0.4),
                           rotation=(0, 0, 2.0), rotation_order="rzxz",
                           center=_center((64, 24, 24)))
GLOBAL_M = transform_matrix(rotation=(70.0, 30.0, -10.0),
                            rotation_order="rzxz",
                            center=_center((64, 24, 24)))


def test_mesh():
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.axis_names == ("shard",)
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert mesh.distinct == (torch.device("cpu"),)
    assert make_mesh(device="cpu").size == 1
    assert Mesh(["cpu", torch.device("cpu")], "z").axis_names == ("z",)
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(device="tpu")
    if not torch.cuda.is_available():
        # the default mesh is the CUDA devices', and never falls back
        with pytest.raises(ValueError):
            make_mesh()
        with pytest.raises(ValueError):
            ShardedVolume(np.zeros((8, 8, 8), np.float32))


def test_halo_estimation(volume):
    m = translation_matrix((2.0, 0.0, 0.0))
    h = halo_for_matrix(volume.shape, m, "linear")
    assert h is not None and 3 <= h <= 4
    big = rotation_matrix((0.0, 90.0, 0.0), "deg", "sxyz")
    h_big = halo_for_matrix(volume.shape, big, "linear")
    assert h_big is None or h_big > 8
    for mat in (m, big, LOCAL_M, GLOBAL_M):
        for interp in ("linear", "filt_bspline"):
            assert halo_for_matrix(volume.shape, mat, interp) == \
                jpar.halo_for_matrix(volume.shape, mat, interp)


@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
def test_sharded_local_transform(jmesh, mesh, volume, interpolation):
    """A small translation takes the halo body; it equals the JAX
    package's sharded call and the single-device port."""
    assert halo_for_matrix(volume.shape, LOCAL_M, interpolation) is not None
    got = ShardedVolume(volume, interpolation, mesh=mesh).affine(LOCAL_M)
    want = jpar.ShardedVolume(volume, interpolation,
                              mesh=jmesh).affine(LOCAL_M)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    single = StaticVolume(volume, interpolation, device="cpu").affine(
        LOCAL_M)
    np.testing.assert_allclose(got, single, atol=ATOL, rtol=0)


@pytest.mark.parametrize("strategy", ["stream", "gather"])
@pytest.mark.parametrize("interpolation", ["linear", "bspline"])
def test_sharded_global_transform(jmesh, mesh, volume, interpolation,
                                  strategy):
    """A large rotation takes the global body, ring stream or all-gather;
    both equal the JAX package's sharded call and the single-device
    result."""
    halo = halo_for_matrix(volume.shape, GLOBAL_M, interpolation)
    assert halo is None or halo + 1 > volume.shape[0] // mesh.size
    got = ShardedVolume(volume, interpolation, mesh=mesh,
                        global_strategy=strategy).affine(GLOBAL_M)
    # the JAX package's cubic stream compiles for about 10 s: its gather
    # body, which its own tests hold to the stream at 3e-5, stands in
    jax_strategy = "gather" if interpolation == "bspline" else strategy
    want = jpar.ShardedVolume(volume, interpolation, mesh=jmesh,
                              global_strategy=jax_strategy).affine(GLOBAL_M)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    single = jvt.affine(volume, GLOBAL_M, interpolation=interpolation,
                        device="jax")
    np.testing.assert_allclose(got, single, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["constant", "border"])
def test_sharded_stream_full_3d_rotation(jmesh, mesh, mode):
    """The ring stream against the single-device oracle for a full 3-D
    rotation (every source slab reaches every output slab), both
    interpolation families, both edges, cval != 0; the JAX package's
    sharded stream on the linear one."""
    rng = np.random.default_rng(17)
    vol = rng.random((48, 20, 28)).astype(np.float32)
    m = np.asarray(transform_matrix(
        rotation=(111.0, -67.0, 148.0), rotation_order="sxyz",
        center=tuple(s / 2 for s in vol.shape)), np.float32)
    assert halo_for_matrix(vol.shape, m, "linear") is None
    for interpolation in ("linear", "filt_bspline"):
        got = ShardedVolume(vol, interpolation, mesh=mesh, mode=mode,
                            cval=0.25).affine(m)
        want = np.asarray(jax_affine_sample(vol, m, interpolation, mode,
                                            0.25))
        assert _off_knife(got, want, m) < KNIFE_ATOL, (interpolation, mode)
    jax_stream = jpar.ShardedVolume(vol, "linear", mesh=jmesh, mode=mode,
                                    cval=0.25).affine(m)
    got = ShardedVolume(vol, "linear", mesh=mesh, mode=mode,
                        cval=0.25).affine(m)
    assert _off_knife(got, jax_stream, m) < KNIFE_ATOL


def test_stream_global_never_materialises_full_volume(mesh, volume):
    """The memory contract of the default global body: no 3-D tensor of
    more than a slab's planes is made while it runs (slab-sized buffers
    only), while the 'gather' body does make one (the positive control
    for the detector)."""
    d0 = volume.shape[0]
    local = d0 // mesh.size
    m = np.asarray(GLOBAL_M, np.float32)

    sv = ShardedVolume(volume, mesh=mesh)       # default: stream
    with DispatchShapes() as seen:
        outs = sv._stream_body(m)
    assert len(outs) == mesh.size and seen.shapes
    big = [s for s in seen.shapes if len(s) == 3 and s[0] > local]
    assert not big, f"full-size tensors in the stream body: {big}"

    svg = ShardedVolume(volume, mesh=mesh, global_strategy="gather")
    with DispatchShapes() as seen:
        svg._gather_body(m)
    assert [s for s in seen.shapes if len(s) == 3 and s[0] >= d0], \
        "the detector did not see the gather body's full volume"


def test_sharded_edge_semantics(jmesh, mesh, volume):
    """Content pushed past the global edge vanishes; it does not wrap
    round the ring between shards."""
    m = translation_matrix((5.0, 0.0, 0.0))
    got = ShardedVolume(volume, mesh=mesh).affine(m)
    want = jpar.ShardedVolume(volume, mesh=jmesh).affine(m)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, jvt.affine(volume, m, device="jax"),
                               atol=ATOL, rtol=0)
    assert np.allclose(got[:5], 0.0, atol=1e-6)


def test_sharded_output_device(jmesh, mesh, volume):
    """``output='device'`` returns the per-shard tensors in z order, each
    on its shard's device: the counterpart of a sharded ``jax.Array``."""
    sv = ShardedVolume(volume, mesh=mesh)
    res = sv.affine(np.eye(4, dtype=np.float32), output="device")
    assert isinstance(res, tuple) and len(res) == mesh.size
    assert all(isinstance(t, torch.Tensor) and t.device == d
               and t.shape == (8, 24, 24) for t, d in zip(res,
                                                          mesh.devices))
    full = torch.cat(res).numpy()
    np.testing.assert_allclose(full, volume, atol=1e-6)
    jres = jpar.ShardedVolume(volume, mesh=jmesh).affine(
        np.eye(4, dtype=np.float32), output="device")
    np.testing.assert_allclose(full, np.asarray(jres), atol=1e-6)
    with pytest.raises(ValueError):
        sv.affine(np.eye(4), output="host")


def test_sharded_validation(mesh, volume):
    with pytest.raises(ValueError):
        ShardedVolume(np.zeros((8, 8), np.float32), mesh=mesh)
    with pytest.raises(ValueError, match="global_strategy"):
        ShardedVolume(volume, mesh=mesh, global_strategy="ring")
    with pytest.raises(ValueError, match="mode"):
        ShardedVolume(volume, mesh=mesh, mode="wrap")
    with pytest.raises(ValueError, match="Interpolation"):
        ShardedVolume(volume, "nearest", mesh=mesh)


@pytest.mark.parametrize("shape", [(61, 24, 24), (9, 24, 26)])
@pytest.mark.parametrize("mode", ["constant", "border"])
def test_sharded_non_divisible_extent(mesh, shape, mode):
    """An axis-0 extent that does not divide the mesh is padded with
    mode-correct planes, masked against the true extent and cropped; on
    the halo and the global path it matches the single-device oracle.
    (61: pad 3; 9: pad 7, so whole shards lie in the pad.)"""
    rng = np.random.default_rng(3)
    vol = rng.random(shape).astype(np.float32)
    for strategy in ("stream", "gather"):
        sv = ShardedVolume(vol, mesh=mesh, interpolation="filt_bspline",
                           mode=mode, global_strategy=strategy)
        for rot in [(3, -4, 5), (40, 55, -70)]:   # halo path, global path
            m = np.asarray(transform_matrix(
                rotation=rot, rotation_order="sxyz",
                center=tuple(s / 2 for s in shape)), np.float32)
            got = sv.affine(m)
            assert got.shape == shape
            want = np.asarray(jax_affine_sample(vol, m, "filt_bspline",
                                                mode))
            err = _off_knife(got, want, m)
            assert err < KNIFE_ATOL, (shape, mode, strategy, rot, err)


def test_sharded_non_divisible_matches_jax_sharded(jmesh, mesh):
    """The padded extent against the JAX package's own sharded call (the
    cell its quick run keeps; its gather body, as its cubic stream
    compiles for about 10 s), both of the port's global bodies."""
    rng = np.random.default_rng(3)
    vol = rng.random((9, 24, 26)).astype(np.float32)
    kw = dict(interpolation="filt_bspline", mode="border")
    jsv = jpar.ShardedVolume(vol, mesh=jmesh, global_strategy="gather", **kw)
    svs = [ShardedVolume(vol, mesh=mesh, global_strategy=strategy, **kw)
           for strategy in ("stream", "gather")]
    for rot in [(3, -4, 5), (40, 55, -70)]:
        m = np.asarray(transform_matrix(
            rotation=rot, rotation_order="sxyz",
            center=tuple(s / 2 for s in vol.shape)), np.float32)
        want = jsv.affine(m)
        for sv in svs:
            assert _off_knife(sv.affine(m), want, m) < KNIFE_ATOL


def test_sharded_affine_batch(jmesh, mesh, volume):
    ms = np.stack([rotation_matrix((a, 0, 0), "deg", "rzxz")
                   for a in np.linspace(0, 35, 8)])
    got = sharded_affine_batch(volume, ms, mesh=mesh)
    assert got.shape == (8,) + volume.shape
    want = jpar.sharded_affine_batch(volume, ms, mesh=jmesh)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for i in (0, 3, 7):
        np.testing.assert_allclose(
            got[i], jvt.affine(volume, ms[i], device="jax"), atol=ATOL,
            rtol=0)


def test_sharded_batch_tilt_envelope(jmesh):
    """The tilt sweep of ``test_sharded_batch_pallas_plan``: each shard
    resamples its share in one launch of the planner's kernel (here its
    plain version), off knife edges equal to the JAX package's sharded
    batch; ``output='device'`` gives the per-shard stacks, cubic too."""
    rng = np.random.default_rng(3)
    vol = rng.random((48, 48, 48)).astype(np.float32)
    c = (np.asarray(vol.shape) - 1) / 2
    ms = np.stack([
        np.asarray(transform_matrix(rotation=(0.0, a, 0.0),
                                    rotation_order="rzxz", center=c),
                   np.float32)
        for a in np.linspace(-21.0, 21.0, 8)])
    mesh4 = make_mesh(4, device="cpu")
    got = sharded_affine_batch(vol, ms, mesh=mesh4)
    assert last_dispatch()["impl"] == "torch"
    want = jpar.sharded_affine_batch(vol, ms, mesh=jmesh)
    for i, m in enumerate(ms):
        assert _off_knife(got[i], want[i], m) <= 5e-5
    stacks = sharded_affine_batch(vol, ms, "filt_bspline", mesh=mesh4,
                                  output="device")
    assert [tuple(s.shape) for s in stacks] == [(2, 48, 48, 48)] * 4
    single = StaticVolume(vol, "filt_bspline", device="cpu").affine_batch(
        ms)
    np.testing.assert_allclose(torch.cat(stacks).numpy(), single,
                               atol=ATOL, rtol=0)


def test_sharded_batch_validation(mesh, volume):
    with pytest.raises(ValueError):
        sharded_affine_batch(volume, np.eye(4, dtype=np.float32), mesh=mesh)
    with pytest.raises(ValueError, match="output shape"):
        sharded_affine_batch(volume, np.eye(4, dtype=np.float32)[None],
                             mesh=mesh, output=np.empty(volume.shape,
                                                        np.float32))


def test_sharded_batch_non_divisible(jmesh, mesh, volume):
    """A batch that does not divide the mesh is padded with repeats of the
    last matrix and cropped on return."""
    rng = np.random.default_rng(2)
    ms = np.stack([np.asarray(transform_matrix(
        rotation=tuple(rng.uniform(-20, 20, 3)), rotation_order="sxyz",
        center=tuple(s / 2 for s in volume.shape)), np.float32)
        for _ in range(3)])   # 3 % 8 != 0
    got = sharded_affine_batch(volume, ms, mesh=mesh)
    assert got.shape == (3,) + volume.shape
    want = jpar.sharded_affine_batch(volume, ms, mesh=jmesh)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    for i in range(3):
        np.testing.assert_allclose(
            got[i], np.asarray(jax_affine_sample(volume, ms[i], "linear",
                                                 "constant")),
            atol=5e-5, rtol=0)
    buf = np.empty((3,) + volume.shape, np.float32)
    assert sharded_affine_batch(volume, ms, mesh=mesh, output=buf) is None
    np.testing.assert_array_equal(buf, got)


def test_sharded_prefilter_matches_global(jmesh, mesh):
    """Slabs thicker than the FIR's support are prefiltered shard by
    shard (halo FIR) and match the global prefilter and the JAX package's
    sharded coefficients; a transform through them matches the single
    device."""
    import jax

    from voltools_tpu.ops.prefilter import bspline_prefilter
    rng = np.random.default_rng(7)
    vol = rng.random((192, 16, 16)).astype(np.float32)
    sv = ShardedVolume(vol, interpolation="filt_bspline", mesh=mesh)
    coef = torch.cat(sv.data).numpy()
    want = np.asarray(jax.jit(bspline_prefilter)(vol))
    np.testing.assert_allclose(coef, want, atol=PREFILTER_ATOL, rtol=0)
    jsv = jpar.ShardedVolume(vol, interpolation="filt_bspline", mesh=jmesh)
    np.testing.assert_allclose(coef, np.asarray(jsv.data),
                               atol=PREFILTER_ATOL, rtol=0)
    m = transform_matrix(rotation=(10, 4, -7), rotation_order="rzxz",
                         center=(95.5, 7.5, 7.5))
    want_t = jvt.affine(vol, m, interpolation="filt_bspline", device="jax")
    np.testing.assert_allclose(sv.affine(m), want_t, atol=5e-5, rtol=0)


def test_sharded_output_buffer_guard(mesh, volume):
    """A wrong-shaped buffer raises; a right-shaped one is filled, and the
    call returns None."""
    sv = ShardedVolume(volume, mesh=mesh)
    m = rotation_matrix((5.0, 0.0, 0.0), "deg", "rzxz")
    with pytest.raises(ValueError, match="output shape"):
        sv.affine(m, output=np.empty((2,) + volume.shape, np.float32))
    buf = np.empty(volume.shape, np.float32)
    assert sv.affine(m, output=buf) is None
    np.testing.assert_array_equal(buf, sv.affine(m))


def test_sharded_thin_volume_mirror_pad_error(mesh):
    """A volume too thin to mirror-pad to the mesh's multiple raises a
    ValueError naming the constraint; mode='border' zero-pads it."""
    thin = np.random.default_rng(0).random((7, 16, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="mirror-pad"):
        ShardedVolume(thin, mesh=mesh)
    sv = ShardedVolume(thin, mesh=mesh, mode="border")
    assert sv.shape == (7, 16, 16)
    got = sv.affine(np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(got, thin, atol=1e-6)


def test_sharded_from_state(jmesh, mesh):
    """A JAX ShardedVolume's state (filt_bspline, padded extent) carried
    over gives the same transforms, local and global, within 3e-5."""
    rng = np.random.default_rng(5)
    vol = rng.random((61, 24, 24)).astype(np.float32)
    jsv = jpar.ShardedVolume(vol, "filt_bspline", mesh=jmesh,
                             global_strategy="gather")
    assert np.asarray(jsv.data).shape == (64, 24, 24)
    sv = sharded_from_state(np.asarray(jsv.data), jsv.shape, jsv.interpolation,
                            jsv.mode, jsv.cval, mesh, jsv.global_strategy)
    assert sv.shape == jsv.shape and sv.global_strategy == "gather"
    np.testing.assert_array_equal(torch.cat(sv.data).numpy(),
                                  np.asarray(jsv.data))
    for rot in [(3, -4, 5), (40, 55, -70)]:
        m = np.asarray(transform_matrix(
            rotation=rot, rotation_order="sxyz",
            center=tuple(s / 2 for s in vol.shape)), np.float32)
        np.testing.assert_allclose(sv.affine(m), jsv.affine(m), atol=ATOL,
                                   rtol=0)
    # a mesh of another size pads the same coefficients anew
    sv3 = sharded_from_state(np.asarray(jsv.data), jsv.shape,
                             "filt_bspline", "constant", 0.0,
                             make_mesh(3, device="cpu"), "stream")
    m = np.asarray(transform_matrix(rotation=(3, -4, 5),
                                    rotation_order="sxyz",
                                    center=(30.5, 12.0, 12.0)), np.float32)
    np.testing.assert_allclose(sv3.affine(m), jsv.affine(m), atol=ATOL,
                               rtol=0)
    with pytest.raises(ValueError):
        sharded_from_state(np.asarray(jsv.data), (70, 24, 24),
                           "filt_bspline", "constant", 0.0, mesh, "stream")


def test_crop_drops_shards_in_the_pad():
    slabs = [torch.full((2, 1, 1), float(i)) for i in range(8)]
    out = _crop(slabs, 9)
    assert [tuple(s.shape) for s in out] == [(2, 1, 1)] * 4 + [(1, 1, 1)]
    assert _crop(slabs, 16) == tuple(slabs)

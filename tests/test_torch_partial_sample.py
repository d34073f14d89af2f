"""The kernel D's plain versions and its wrappers on the CPU, against the JAX
package.

``voltools_tpu_torch.kernels.partial_sample`` holds the sharded paths'
per-slab partial sample: D1, one step of ``ShardedVolume``'s ring stream
(:func:`partial_sample`, plain version :func:`plain_partial_step` over
:func:`plain_partial_sample`), and D2, a shard's part of the volume-sharded
SIRT forward (:func:`partial_project`, plain version
:func:`plain_partial_project`).  On CPU tensors the wrappers run the plain
versions; the kernels run on the card only (``tests/test_torch_cuda.py``).
Here, on small shapes with seeded inputs:

* the wrappers equal the plain versions bit for bit, and the ring of
  :func:`partial_sample` steps equals the stream body's former composition
  (the partials summed, then the whole-sample mask) bit for bit;
* :func:`plain_partial_sample` against the JAX package's
  ``_partial_sample_pertap`` on the same coordinates (atol 1e-6, as
  ``tests/test_torch_parallel_models.py`` holds the per-tap trilinear);
* the partials of all slabs sum to the single-device sample, within the
  error of summing the same taps in two orders;
* a torch emulation of D2's order (each ray's planes summed in turn, the
  JAX ``fori_loop``'s) against :func:`plain_partial_project` within
  :func:`sum_order_atol`, and, as the forward of the mesh SIRT, against
  the JAX package's mesh SIRT on the 8 host devices ``tests/conftest.py``
  forces."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from voltools_tpu import parallel as jpar
from voltools_tpu import models as jm
from voltools_tpu.parallel.sharded import \
    _partial_sample_pertap as jax_partial_sample
from voltools_tpu_torch import models as tm
from voltools_tpu_torch.kernels.partial_sample import (
    _trilinear3d_pertap, partial_project, partial_sample,
    plain_partial_project, plain_partial_sample, plain_partial_step,
    sample_frame, sum_order_atol)
from voltools_tpu_torch.models import reconstruction
from voltools_tpu_torch.ops.interpolation import _inside
from voltools_tpu_torch.ops.sampling import affine_coords, affine_sample
from voltools_tpu_torch.parallel import ShardedVolume, make_mesh
from voltools_tpu_torch.parallel.sharded import _shifted
from voltools_tpu_torch.utils import transform_matrix, translation_matrix

JAX_ATOL = 1e-6
SIRT_ATOL = 5e-5     # tests/test_torch_parallel_models.py's mesh SIRT
# (shape, shards): a depth that pads the last shard, and one that divides
CASES = [((21, 12, 10), 4), ((16, 14, 12), 2)]
INTERPOLATION = {1: "linear", 3: "bspline"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _matrices(shape, seed):
    """Pull-back matrices whose taps cross slab boundaries and the global
    edges: two random 'sxyz' rotations, a half-voxel shift along z (every
    stencil straddles two planes), a shift and a scale past the edges."""
    rng = np.random.default_rng(seed)
    center = tuple(s / 2 for s in shape)
    ms = [transform_matrix(rotation=tuple(rng.uniform(-180, 180, 3)),
                           rotation_order="sxyz", center=center)
          for _ in range(2)]
    ms += [translation_matrix((0.5, 0.3, -0.25)),
           translation_matrix((-1.5, 0.8, 1.2)),
           transform_matrix(scale=(1.15, 0.9, 1.05), center=center)]
    return [np.asarray(m, np.float32) for m in ms]


def _volume(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _former_stream(sv, m):
    """The stream body as it was before the kernel D: per shard, the
    partials of the slabs in ring order summed everywhere, then the
    whole-sample mask with cval."""
    n, local, shape = sv.mesh.size, sv._local, sv.shape
    outs = []
    for i in range(n):
        coords = affine_coords((local,) + shape[1:],
                               _shifted(m, np.float32(i * local)))
        acc = torch.zeros((local,) + shape[1:])
        for k in range(n):
            j = (i - k) % n
            acc = acc + plain_partial_sample(sv.data[j], coords, j * local,
                                             shape, sv.interpolation,
                                             sv.mode)
        inside = _inside(coords[0], coords[1], coords[2], shape, sv.mode)
        outs.append(acc.masked_fill_(~inside, sv.cval))
    return torch.cat(outs)


@pytest.mark.parametrize("shape,shards", CASES)
@pytest.mark.parametrize("mode,cval", [("constant", 0.0), ("border", 1.5)])
@pytest.mark.parametrize("order", [1, 3])
def test_stream_body_equals_the_former_composition(shape, shards, mode, cval,
                                                   order):
    """The stream body's ring of partial_sample steps on CPU shards equals,
    bit for bit, the partials summed and then masked (the plain version
    the kernel D1 is held to); and so does the body's plain reference."""
    sv = ShardedVolume(_volume(shape), INTERPOLATION[order],
                       mesh=make_mesh(shards, device="cpu"), mode=mode,
                       cval=cval)
    for m in _matrices(shape, seed=shards):
        want = _former_stream(sv, m)
        assert torch.equal(torch.cat(sv._stream_body(m)), want)
        assert torch.equal(torch.cat(sv._stream_body(m, plain=True)), want)


@pytest.mark.parametrize("last", [False, True])
def test_partial_sample_on_cpu_is_the_plain_step(last):
    """The wrapper on CPU tensors is plain_partial_step, bit for bit: the
    inside voxels gain the partial, the others keep their value, or take
    cval on the last step."""
    shape, z0, loc = (21, 12, 10), 6, 6
    vol = torch.from_numpy(_volume(shape, seed=3))
    m = _matrices(shape, seed=5)[0]
    start = torch.from_numpy(_volume((6,) + shape[1:], seed=4))
    got = partial_sample(vol[z0:z0 + loc].contiguous(), m, z0, shape, 3,
                         "border", start.clone(), last=last, cval=2.0)
    frame = sample_frame(m, (6,) + shape[1:], shape, "border", "cpu")
    want = plain_partial_step(vol[z0:z0 + loc].contiguous(), *frame, z0,
                              shape, 3, "border", start.clone(), last=last,
                              cval=2.0)
    assert torch.equal(got, want)
    coords = affine_coords((6,) + shape[1:], m)
    inside = _inside(coords[0], coords[1], coords[2], shape, "border")
    part = plain_partial_sample(vol[z0:z0 + loc], coords, z0, shape,
                                "bspline", "border")
    expect = torch.where(inside, start + part, 2.0 if last else start)
    assert torch.equal(got, expect)


@pytest.mark.parametrize("slab", ["top", "middle", "bottom"])
@pytest.mark.parametrize("mode", ["constant", "border"])
@pytest.mark.parametrize("order", [1, 3])
def test_plain_partial_sample_matches_jax(slab, mode, order):
    """plain_partial_sample against the JAX package's _partial_sample_pertap
    on the same global coordinates (a random rotation, a half-voxel shift
    and a scale past the edges, over the whole volume's output), for the
    top, a middle and the bottom slab of a (21, 12, 10) volume in slabs of
    6 planes (the last padded)."""
    shape, loc = (21, 12, 10), 6
    z0 = {"top": 0, "middle": 6, "bottom": 18}[slab]
    vol = _volume(shape, seed=7)
    padded = np.zeros((24,) + shape[1:], np.float32)
    padded[:21] = vol
    block = np.ascontiguousarray(padded[z0:z0 + loc])
    for m in _matrices(shape, seed=11)[1:]:
        coords = affine_coords(shape, m)
        got = plain_partial_sample(torch.from_numpy(block), coords, z0, shape,
                                   INTERPOLATION[order], mode)
        want = np.asarray(jax_partial_sample(block, coords.numpy(), z0,
                                             shape, INTERPOLATION[order],
                                             mode))
        assert got.any()
        np.testing.assert_allclose(got.numpy(), want, atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("shape,shards", CASES)
@pytest.mark.parametrize("mode", ["constant", "border"])
@pytest.mark.parametrize("order", [1, 3])
def test_partials_sum_to_the_single_device_sample(shape, shards, mode,
                                                  order):
    """Each shard of the stream body's ring (D1's plain steps) against the
    single-device plain sampler at the shard's own coordinates (its
    slab-shifted matrix): the same taps, with the same weights, summed in
    two orders (a partial per slab, then the partials), so within twice
    the error of a float32 sum of k^3 terms of weight at most 1 on values
    in [0, 1): 2 (k^3 - 1) 2**-24."""
    vol = _volume(shape, seed=order)
    sv = ShardedVolume(vol, INTERPOLATION[order],
                       mesh=make_mesh(shards, device="cpu"), mode=mode,
                       cval=0.5)
    local = sv._local
    atol = 2 * ((order + 1) ** 3 - 1) * 2.0 ** -24
    for m in _matrices(shape, seed=2):
        for i, got in enumerate(sv._stream_body(m)):
            want = affine_sample(torch.from_numpy(vol),
                                 _shifted(m, np.float32(i * local)),
                                 INTERPOLATION[order], mode, 0.5,
                                 prefiltered=True,
                                 out_shape=(local,) + shape[1:])
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol,
                                       rtol=0)


def _sequential_project(x_slab, matrices, off, out_shape, projection_axis):
    """A torch emulation of D2's order: for each tilt, each ray's per-plane
    samples (the plain version's arithmetic, plane by plane) added in plane
    order to a sum that starts at 0 (the JAX package's ``fori_loop``)."""
    keep = [a for a in range(3) if a != projection_axis]
    n_a, n_b = out_shape[keep[0]], out_shape[keep[1]]
    n_p = out_shape[projection_axis]
    grids = {keep[0]: torch.arange(n_a, dtype=torch.float32).view(1, n_a, 1),
             keep[1]: torch.arange(n_b, dtype=torch.float32).view(1, 1, n_b)}
    planes = torch.arange(n_p, dtype=torch.float32).view(n_p, 1, 1)
    result = torch.zeros((len(matrices), n_a, n_b))
    for n, m in enumerate(matrices):
        rows = [[float(v) for v in m[r]] for r in range(3)]
        acc = torch.zeros((n_a, n_b))
        for p in range(n_p):
            w = dict(grids)
            w[projection_axis] = planes[p:p + 1]
            s = [rows[r][0] * w[0] + rows[r][1] * w[1] + rows[r][2] * w[2]
                 + rows[r][3] for r in range(3)]
            inside = ((s[0] >= 0) & (s[0] <= out_shape[0] - 1)
                      & (s[1] >= 0) & (s[1] <= out_shape[1] - 1)
                      & (s[2] >= 0) & (s[2] <= out_shape[2] - 1))
            val = _trilinear3d_pertap(x_slab, s[0] - off, s[1], s[2])
            acc = acc + torch.where(inside, val, 0.0)[0]
        result[n] = acc
    return result


def _tilts(shape, tilt_axis=0):
    proj = tm.TiltSeriesProjector(_volume(shape), "linear", device="cpu")
    return proj.tilt_matrices(np.arange(-60.0, 61.0, 15.0),
                              tilt_axis=tilt_axis)


@pytest.mark.parametrize("shape,shards", CASES)
@pytest.mark.parametrize("projection_axis", [0, 1, 2])
def test_sequential_projection_within_the_sum_order_bound(shape, shards,
                                                          projection_axis):
    """D2's plane order against plain_partial_project, per slab of the
    mesh, on signed values: within sum_order_atol of the plain partial
    projection of the slab's magnitudes; and the wrapper on CPU tensors
    is plain_partial_project, bit for bit."""
    rng = np.random.default_rng(sum(shape) + projection_axis)
    ms = np.concatenate([_tilts(shape), np.stack(_matrices(shape, seed=9))])
    local = -(-shape[0] // shards)
    vol = np.zeros((local * shards,) + shape[1:], np.float32)
    vol[:shape[0]] = rng.standard_normal(shape)
    for i in range(shards):
        x = torch.from_numpy(vol[i * local:(i + 1) * local].copy())
        off = float(np.float32(i * local))
        plain = plain_partial_project(x, ms, off, shape, projection_axis)
        assert torch.equal(partial_project(x, ms, off, shape,
                                           projection_axis), plain)
        got = _sequential_project(x, ms, off, shape, projection_axis)
        largest = float(plain_partial_project(x.abs(), ms, off, shape,
                                              projection_axis).max())
        atol = sum_order_atol(shape[projection_axis], largest)
        assert float((got - plain).abs().max()) <= atol


def test_sequential_forward_mesh_sirt_matches_jax(monkeypatch):
    """The mesh SIRT with D2's plane order as its forward (one iteration,
    8 CPU shards of a (24, 20, 20) volume) against the JAX package's mesh
    SIRT on 8 host devices, at the mesh SIRT tests' tolerance."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(3)
    vol = gaussian_filter(rng.standard_normal((24, 20, 20)),
                          2.0).astype(np.float32)
    jproj = jm.TiltSeriesProjector(vol, "linear", device="jax")
    angles = np.arange(-60.0, 61.0, 15.0)
    ms = jproj.tilt_matrices(angles, tilt_axis=0)
    p = jproj.project(angles, tilt_axis=0)
    want = jm.sirt_reconstruct(p, ms, vol.shape, iterations=1,
                               mesh=jpar.make_mesh(8))
    monkeypatch.setattr(reconstruction, "partial_project",
                        _sequential_project)
    got = tm.sirt_reconstruct(p, ms, vol.shape, iterations=1,
                              mesh=make_mesh(8, device="cpu"))
    np.testing.assert_allclose(got, want, atol=SIRT_ATOL, rtol=0)


def test_wrappers_check_their_arguments():
    """Bad arguments raise; a tensor on neither the CPU nor a CUDA device
    never reaches the plain version."""
    shape = (8, 6, 5)
    slab = torch.zeros((4,) + shape[1:])
    acc = torch.zeros((4,) + shape[1:])
    m = np.eye(4, dtype=np.float32)
    with pytest.raises(ValueError, match="float32"):
        partial_sample(slab, m.astype(np.float64), 0, shape, 1, "constant",
                       acc)
    with pytest.raises(ValueError, match="order"):
        partial_sample(slab, m, 0, shape, 2, "constant", acc)
    with pytest.raises(ValueError, match="mode"):
        partial_sample(slab, m, 0, shape, 1, "wrap", acc)
    with pytest.raises(ValueError, match="planes of a volume"):
        partial_sample(slab, m, 0, (8, 6, 6), 1, "constant", acc)
    with pytest.raises(ValueError, match="contiguous"):
        partial_sample(slab, m, 0, shape, 1, "constant",
                       torch.zeros((4, 5, 6)).transpose(1, 2))
    meta = torch.zeros((4,) + shape[1:], device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        partial_sample(meta, m, 0, shape, 1, "constant",
                       torch.zeros_like(meta))
    with pytest.raises(ValueError, match="unsupported device"):
        partial_project(meta, m[None], 0.0, shape, 0)
    with pytest.raises(ValueError, match="matrices"):
        partial_project(slab, m, 0.0, shape, 0)
    with pytest.raises(ValueError, match="projection_axis"):
        partial_project(slab, m[None], 0.0, shape, 3)

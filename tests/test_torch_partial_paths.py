"""The two paths of the kernel D's redesign on the CPU: D2's line path and
D1's ring in one launch a shard.

``voltools_tpu_torch.kernels.partial_sample`` launches D2's line path
where :func:`line_axis` finds a ray axis that every matrix leaves alone
(the mesh SIRT's tilt series), and D1's ring entry
(:func:`partial_sample_ring`) where every source slab of a shard lies on
its device.  The kernels run on the card only (``tests/test_torch_cuda.py``);
here, at 16-24^3 on 4 shards with inputs from numpy seeds:

* :func:`line_axis` on tilt series, random rotations, a matrix one ulp off
  and a series whose untouched axis is the projection axis;
* a torch emulation of the line path's per-sample arithmetic (the line's
  coordinates formed once with the line index 0, four taps at column b,
  weighted w_z * w_q) equals the masked ``_trilinear3d_pertap`` samples
  bit for bit on the line geometry, and its plane-ordered sum lies within
  :func:`sum_order_atol` of the JAX package's ``fwd_partial`` (written out
  here from ``voltools_tpu/models/reconstruction.py:535-556`` over the
  JAX package's own ``_trilinear3d_pertap``);
* a plain emulation of the ring kernel (coordinates and taps once, the
  slabs in ring order, a slab added only where one of its z taps lands)
  equals the chain of :func:`plain_partial_step` calls bit for bit, and so
  do the ring wrapper on CPU tensors and the stream body;
* the ring wrapper's argument checks."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from voltools_tpu.models.reconstruction import \
    _trilinear3d_pertap as jax_trilinear3d_pertap
from voltools_tpu_torch import models as tm
from voltools_tpu_torch.kernels.partial_sample import (
    _trilinear3d_pertap, line_axis, partial_project,
    partial_sample_ring, plain_partial_project, plain_partial_ring,
    plain_partial_sample, plain_partial_step, sample_frame, sum_order_atol)
from voltools_tpu_torch.ops.interpolation import _mirror_index
from voltools_tpu_torch.parallel import ShardedVolume, make_mesh
from voltools_tpu_torch.parallel.sharded import _shifted
from voltools_tpu_torch.utils import transform_matrix, translation_matrix

SHARDS = 4
ANGLES = np.arange(-60.0, 61.0, 15.0)
INTERPOLATION = {1: "linear", 3: "bspline"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tilts(shape, position):
    """The projector's tilt series: the angle at ``position`` of the
    'rzxz' triple, about the centre (n - 1) / 2."""
    proj = tm.TiltSeriesProjector(np.zeros(shape, np.float32), "linear",
                                  device="cpu")
    return proj.tilt_matrices(ANGLES, tilt_axis=position)


def _random(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    center = tuple((s - 1) / 2 for s in shape)
    return np.stack([np.asarray(transform_matrix(
        rotation=tuple(rng.uniform(-180, 180, 3)), rotation_order="sxyz",
        center=center), np.float32) for _ in range(n)])


def _off_by_an_ulp(ms, where):
    ms = ms.copy()
    ms[len(ms) // 2][where] = np.nextafter(ms[len(ms) // 2][where],
                                           np.float32(2))
    return ms


SHAPE = (20, 16, 18)
LINE_AXIS_CASES = {
    # a tilt about an axis of the projection plane leaves the rays' second
    # axis alone: the mesh SIRT's series (position 0) and position 2
    "position_0_axis_0": (_tilts(SHAPE, 0), 0, 2),
    "position_2_axis_0": (_tilts(SHAPE, 2), 0, 2),
    "position_0_axis_1": (_tilts(SHAPE, 0), 1, 2),
    # position 1 turns about array axis 0: with projection axis 0 the axis
    # it leaves alone is the projection axis; with axis 1 it is the rays'
    # first axis, which the general kernel serves
    "position_1_axis_0": (_tilts(SHAPE, 1), 0, None),
    "position_1_axis_1": (_tilts(SHAPE, 1), 1, 0),
    "random_rotations": (_random(SHAPE, 1), 0, None),
    "row_2_off_by_an_ulp": (_off_by_an_ulp(_tilts(SHAPE, 0), (2, 2)), 0,
                            None),
    "column_2_off_by_an_ulp": (_off_by_an_ulp(_tilts(SHAPE, 0), (0, 2)), 0,
                               None),
    "a_random_rotation_among_tilts": (np.concatenate(
        [_tilts(SHAPE, 0), _random(SHAPE, 2, 1)]), 0, None),
    "identity": (np.eye(4, dtype=np.float32)[None], 0, 2),
}


@pytest.mark.parametrize("case", list(LINE_AXIS_CASES))
def test_line_axis(case):
    """line_axis returns the ray axis every matrix leaves alone, by exact
    float32 equality, the second ray axis first; None where no ray axis
    qualifies."""
    ms, axis, want = LINE_AXIS_CASES[case]
    assert line_axis(ms, axis) == want


def _slabs(shape, seed):
    """4 slabs of a padded volume of standard normal values, their first
    global planes, and the local depth."""
    local = -(-shape[0] // SHARDS)
    vol = np.zeros((local * SHARDS,) + shape[1:], np.float32)
    vol[:shape[0]] = np.random.default_rng(seed).standard_normal(shape)
    return ([torch.from_numpy(vol[i * local:(i + 1) * local].copy())
             for i in range(SHARDS)],
            [float(np.float32(i * local)) for i in range(SHARDS)], local)


def _line_samples(x_slab, m, off, out_shape, projection_axis, plane):
    """The line path's samples of one plane of one tilt, (A, B): its
    per-sample arithmetic in torch.  The two non-line coordinates are
    formed with the line index 0 (their product with column b is the
    same zero for every b), once a row of rays; the four taps (z|z+1,
    q|q+1) at column b weighted (w_z * w_q), summed in that order."""
    keep = [a for a in range(3) if a != projection_axis]
    line, (n_a, n_b) = keep[1], (out_shape[keep[0]], out_shape[keep[1]])
    q_axis = 3 - line
    w = [None] * 3
    w[projection_axis] = torch.full((n_a, 1), float(plane))
    w[keep[0]] = torch.arange(n_a, dtype=torch.float32).view(n_a, 1)
    w[line] = torch.zeros((n_a, 1))
    rows = [[float(v) for v in m[r]] for r in range(3)]
    sz, sq = [rows[r][0] * w[0] + rows[r][1] * w[1] + rows[r][2] * w[2]
              + rows[r][3] for r in (0, q_axis)]
    inside = ((sz >= 0) & (sz <= out_shape[0] - 1) & (sq >= 0)
              & (sq <= out_shape[q_axis] - 1))
    zz = sz - off
    z0f, q0f = torch.floor(zz), torch.floor(sq)
    fz, fq = zz - z0f, sq - q0f
    gz, gq = 1 - fz, 1 - fq
    z, q = z0f.to(torch.int64), q0f.to(torch.int64)
    l, nq = x_slab.shape[0], x_slab.shape[q_axis]
    b = torch.arange(n_b).view(1, n_b)

    def tap(zt, qt, weight):
        valid = (zt >= 0) & (zt < l) & (qt >= 0) & (qt < nq)
        zc, qc = zt.clamp(0, l - 1), qt.clamp(0, nq - 1)
        v = x_slab[zc, qc, b] if line == 2 else x_slab[zc, b, qc]
        return torch.where(valid, v * weight, 0.0)

    val = tap(z, q, gz * gq) + tap(z, q + 1, gz * fq)
    val = val + tap(z + 1, q, fz * gq)
    val = val + tap(z + 1, q + 1, fz * fq)
    return torch.where(inside, val, 0.0)


def _jax_fwd_partial(x_slab, ms, off, out_shape, projection_axis):
    """The JAX package's ``fwd_partial`` (reconstruction.py:535-556)
    without its psum, over its own ``_trilinear3d_pertap``."""
    keep = [a for a in range(3) if a != projection_axis]
    A, B = out_shape[keep[0]], out_shape[keep[1]]
    ia = jax.lax.broadcasted_iota(jnp.float32, (A, B), 0)
    ib = jax.lax.broadcasted_iota(jnp.float32, (A, B), 1)
    x = jnp.asarray(x_slab)

    def one_tilt(m):
        def plane(t, acc):
            w = [None, None, None]
            w[projection_axis] = t.astype(jnp.float32)
            w[keep[0]] = ia
            w[keep[1]] = ib
            s = [m[r, 0] * w[0] + m[r, 1] * w[1] + m[r, 2] * w[2]
                 + m[r, 3] for r in range(3)]
            inside = ((s[0] >= 0) & (s[0] <= out_shape[0] - 1)
                      & (s[1] >= 0) & (s[1] <= out_shape[1] - 1)
                      & (s[2] >= 0) & (s[2] <= out_shape[2] - 1))
            val = jax_trilinear3d_pertap(x, s[0] - off, s[1], s[2])
            return acc + jnp.where(inside, val, 0.0)

        return jax.lax.fori_loop(0, out_shape[projection_axis], plane,
                                 jnp.zeros((A, B), jnp.float32))

    return np.asarray(jax.vmap(one_tilt)(jnp.asarray(ms)))


# (shape, projection axis, the series' position): the mesh SIRT's series,
# an odd shape, position 2, and projection axis 1
LINE_CASES = [((20, 16, 18), 0, 0), ((17, 21, 19), 0, 0),
              ((16, 18, 20), 0, 2), ((18, 20, 16), 1, 0)]


@pytest.mark.parametrize("shape,projection_axis,position", LINE_CASES)
def test_line_path_emulation(shape, projection_axis, position):
    """On the line geometry the line path's samples equal the masked
    per-tap trilinear samples (the general kernel's arithmetic) bit for
    bit at every plane of every tilt, and its plane-ordered sums lie
    within sum_order_atol of the JAX package's fwd_partial and of
    plain_partial_project; the wrapper on CPU tensors is the plain version
    with or without _force_general."""
    ms = _tilts(shape, position)
    keep = [a for a in range(3) if a != projection_axis]
    assert line_axis(ms, projection_axis) == keep[1]
    slabs, offs, local = _slabs(shape, sum(shape) + position)
    n_a, n_b = shape[keep[0]], shape[keep[1]]
    grid = {keep[0]: torch.arange(n_a, dtype=torch.float32).view(n_a, 1),
            keep[1]: torch.arange(n_b, dtype=torch.float32).view(1, n_b)}
    for x, off in zip(slabs[1:3], offs[1:3]):
        sums = torch.zeros((len(ms), n_a, n_b))
        for n, m in enumerate(ms):
            rows = [[float(v) for v in m[r]] for r in range(3)]
            for p in range(shape[projection_axis]):
                got = _line_samples(x, m, off, shape, projection_axis, p)
                w = dict(grid)
                w[projection_axis] = torch.full((1, 1), float(p))
                s = [rows[r][0] * w[0] + rows[r][1] * w[1]
                     + rows[r][2] * w[2] + rows[r][3] for r in range(3)]
                inside = ((s[0] >= 0) & (s[0] <= shape[0] - 1)
                          & (s[1] >= 0) & (s[1] <= shape[1] - 1)
                          & (s[2] >= 0) & (s[2] <= shape[2] - 1))
                want = torch.where(inside, _trilinear3d_pertap(
                    x, s[0] - off, s[1], s[2]), 0.0)
                assert torch.equal(got, want), (n, p)
                sums[n] = sums[n] + got
        largest = float(plain_partial_project(x.abs(), ms, off, shape,
                                              projection_axis).max())
        atol = sum_order_atol(shape[projection_axis], largest)
        jax_sums = _jax_fwd_partial(x.numpy(), ms, off, shape,
                                    projection_axis)
        assert np.abs(sums.numpy() - jax_sums).max() <= atol
        plain = plain_partial_project(x, ms, off, shape, projection_axis)
        assert float((sums - plain).abs().max()) <= atol
        for force in (False, True):
            assert torch.equal(partial_project(
                x, ms, off, shape, projection_axis, _force_general=force),
                plain)


def _z_taps(coords, order, mode, d0):
    """Each voxel's z tap indices as the kernel resolves them, and for
    'border' whether each lies inside the volume."""
    first, taps = (0, 2) if order == 1 else (-1, 4)
    base = torch.floor(coords[0]).to(torch.int64) + first
    out = []
    for t in range(taps):
        i = base + t
        if mode == "border":
            out.append((i.clamp(0, d0 - 1), (i >= 0) & (i < d0)))
        elif order == 3:
            out.append((_mirror_index(i, d0), None))
        else:
            out.append((i.clamp(0, d0 - 1), None))
    return out


def _ring_emulation(slabs, z0s, matrix, true_shape, order, mode, out_shape,
                    cval):
    """The ring kernel's order in torch: coordinates, inside test and z
    taps once; for each slab in ring order, its partial added to a sum
    that starts at 0, only where one of the voxel's z taps lands in the
    slab; cval outside."""
    coords, inside = sample_frame(matrix, out_shape, true_shape, mode, "cpu")
    taps = _z_taps(coords, order, mode, true_shape[0])
    acc = torch.zeros(out_shape)
    for slab, z0 in zip(slabs, z0s):
        owned = torch.zeros(out_shape, dtype=torch.bool)
        for z, ok in taps:
            own = (z >= z0) & (z < z0 + slab.shape[0])
            owned |= own if ok is None else own & ok
        part = plain_partial_sample(slab, coords, z0, true_shape,
                                    INTERPOLATION[order], mode)
        acc = torch.where(owned, acc + part, acc)
    return torch.where(inside, acc, cval)


def _ring_matrices(shape):
    center = tuple(s / 2 for s in shape)
    return [np.asarray(m, np.float32) for m in (
        transform_matrix(rotation=(111, -67, 148), rotation_order="sxyz",
                         center=center),
        translation_matrix((0.5, 0.25, -0.5)),
        transform_matrix(scale=(1.2, 0.85, 1.1), center=center))]


@pytest.mark.parametrize("shape", [(24, 16, 18), (21, 17, 19)])
@pytest.mark.parametrize("mode,cval", [("constant", 0.0), ("border", 1.5),
                                       ("constant", -2.0)])
@pytest.mark.parametrize("order", [1, 3])
def test_ring_equals_the_plain_chain(shape, mode, cval, order):
    """For each shard of a 4-shard ring (21 planes pad to 24): the ring
    kernel's order in torch, the ring wrapper on CPU tensors and the
    stream body equal the chain of plain_partial_step calls bit for bit,
    for a full rotation, a half-voxel shift (every stencil straddles two
    planes, slab boundaries included) and a scale past every edge."""
    vol = np.random.default_rng(sum(shape) + order).random(shape) \
        .astype(np.float32)
    sv = ShardedVolume(vol, INTERPOLATION[order],
                       mesh=make_mesh(SHARDS, device="cpu"), mode=mode,
                       cval=cval)
    local = sv._local
    out_shape = (local,) + shape[1:]
    for m in _ring_matrices(shape):
        body = sv._stream_body(m)
        for i in range(SHARDS):
            ring = [(i - k) % SHARDS for k in range(SHARDS)]
            slabs = [sv.data[j] for j in ring]
            z0s = [j * local for j in ring]
            m_dev = _shifted(m, np.float32(i * local))
            acc = torch.zeros(out_shape)
            frame = sample_frame(m_dev, out_shape, shape, mode, "cpu")
            for k, (slab, z0) in enumerate(zip(slabs, z0s)):
                plain_partial_step(slab, *frame, z0, shape, order, mode, acc,
                                   k == SHARDS - 1, cval)
            assert torch.equal(plain_partial_ring(
                slabs, z0s, m_dev, shape, order, mode, out_shape, cval), acc)
            assert torch.equal(_ring_emulation(
                slabs, z0s, m_dev, shape, order, mode, out_shape, cval), acc)
            assert torch.equal(partial_sample_ring(
                slabs, z0s, m_dev, shape, order, mode, out_shape, cval), acc)
            assert torch.equal(body[i], acc)


def test_ring_wrapper_checks_its_arguments():
    """Bad arguments raise; a tensor on neither the CPU nor a CUDA device
    never reaches the plain version."""
    shape = (8, 6, 5)
    slab = torch.zeros((4,) + shape[1:])
    m = np.eye(4, dtype=np.float32)
    ok = dict(matrix=m, true_shape=shape, order=1, mode="constant",
              out_shape=(4,) + shape[1:])
    assert partial_sample_ring([slab, slab], [0, 4], **ok).shape == (4, 6, 5)
    with pytest.raises(ValueError, match="at least one slab"):
        partial_sample_ring([], [], **ok)
    with pytest.raises(ValueError, match="first plane for each"):
        partial_sample_ring([slab, slab], [0], **ok)
    with pytest.raises(ValueError, match="differ in shape"):
        partial_sample_ring([slab, torch.zeros((3,) + shape[1:])], [0, 4],
                            **ok)
    with pytest.raises(ValueError, match="planes of a volume"):
        partial_sample_ring([slab], [0], **dict(ok, true_shape=(8, 6, 6)))
    with pytest.raises(ValueError, match="float32"):
        partial_sample_ring([slab.double()], [0], **ok)
    with pytest.raises(ValueError, match="float32"):
        partial_sample_ring([slab], [0], **dict(ok, matrix=m.astype(
            np.float64)))
    with pytest.raises(ValueError, match="order"):
        partial_sample_ring([slab], [0], **dict(ok, order=2))
    with pytest.raises(ValueError, match="mode"):
        partial_sample_ring([slab], [0], **dict(ok, mode="wrap"))
    with pytest.raises(ValueError, match="out_shape"):
        partial_sample_ring([slab], [0], **dict(ok, out_shape=(4, 6)))
    with pytest.raises(ValueError, match="contiguous"):
        partial_sample_ring([torch.zeros((4, 5, 6)).transpose(1, 2)], [0],
                            **ok)
    with pytest.raises(TypeError, match="torch tensors"):
        partial_sample_ring([np.zeros((4,) + shape[1:], np.float32)], [0],
                            **ok)
    meta = torch.zeros((4,) + shape[1:], device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        partial_sample_ring([meta], [0], **ok)

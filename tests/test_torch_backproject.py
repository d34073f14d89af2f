"""The back-projection kernel C's wrapper and plain version on the CPU.

``voltools_tpu_torch.kernels.backproject`` holds the adjoint of WBP and
SIRT: the kernel (``csrc/backproject.cu``, card only) and its plain torch
version, which CPU tensors run.  Here:

* the plain version against the JAX package's ``_make_adjoint``
  (``voltools_tpu/models/reconstruction.py:78``, its ``lax.scan`` on the
  CPU) on both paths, on seeded inputs handed over as numpy: projection
  axes 0, 1 and 2, 1 and 7 tilts, an odd non-cubic shape, slab-shifted
  matrices as a volume shard sees them, rows partly and wholly outside
  the projection.  Tolerance: atol 1e-5 of the largest |value| (as
  ``tests/test_torch_models.py``'s adjoint test): the two sum the same
  taps in the same order, but XLA may fuse a multiply and an add;
* the shared row-gather decision against the JAX package's own, read from
  its adjoint's closure;
* the wrapper's checks, and CPU tensors running the plain version with
  the launch counter left at 0;
* the host-side coefficient table: a torch emulation of the kernel's
  per-voxel loop (its index arithmetic, no permute, validity tested on the
  float floor) fed with it reproduces the plain version bit for bit.

The kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from voltools_tpu.models.reconstruction import _make_adjoint as jax_adjoint
from voltools_tpu_torch.kernels import _build, backproject as bp
from voltools_tpu_torch.models.reconstruction import _make_adjoint
from voltools_tpu_torch.parallel.sharded import _shifted

SHAPE = (11, 14, 17)     # odd and non-cubic
RTOL_OF_MAX = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rotation(shape, axis, degrees):
    """The pull-back matrix of a rotation about array ``axis`` by
    ``degrees`` about the volume's centre, float32."""
    i, j = [a for a in range(3) if a != axis]
    c, s = np.cos(np.radians(degrees)), np.sin(np.radians(degrees))
    rot = np.eye(4)
    rot[i, i], rot[i, j], rot[j, i], rot[j, j] = c, -s, s, c
    centre = np.eye(4)
    centre[:3, 3] = (np.asarray(shape) - 1) / 2
    back = np.eye(4)
    back[:3, 3] = -(np.asarray(shape) - 1) / 2
    return (centre @ rot @ back).astype(np.float32)


def _series(shape, projection_axis, n, path, seed):
    """(projections, inverse matrices, keep) of ``n`` tilts: about the
    column axis keep[1] for the row-gather path, about keep[0] and then
    the projection axis for the general one; the last tilt's rows are
    shifted by 0.4 of the projection's height, partly off it."""
    keep = [a for a in range(3) if a != projection_axis]
    angles = np.linspace(-60.0, 60.0, n) if n > 1 else np.array([23.0])
    ms = []
    for a in angles:
        if path == "rowgather":
            m = _rotation(shape, keep[1], a)
        else:
            m = _rotation(shape, keep[0], a) @ _rotation(
                shape, projection_axis, a / 3)
        ms.append(m.astype(np.float32))
    minv = np.stack([np.linalg.inv(m) for m in ms]).astype(np.float32)
    h, w = shape[keep[0]], shape[keep[1]]
    minv[-1, keep[0], 3] += np.float32(0.4 * h)
    projs = np.random.default_rng(seed).random((n, h, w)).astype(np.float32)
    return projs, minv, keep


def _jax(minv, keep, out_shape, projs, minvs, force_general=False):
    return np.asarray(jax_adjoint(minv, keep, out_shape, projs.shape[1:],
                                  _force_general=force_general)(projs,
                                                                minvs))


def _jax_rowgather(minv, keep, out_shape, proj_shape, force_general=False):
    """The JAX adjoint's own decision: the ``rowgather`` cell of the
    closure it returns."""
    adj = jax_adjoint(minv, keep, out_shape, proj_shape,
                      _force_general=force_general)
    cells = dict(zip(adj.__code__.co_freevars, adj.__closure__))
    return cells["rowgather"].cell_contents


def _close(got, want):
    atol = RTOL_OF_MAX * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("n", [1, 7])
@pytest.mark.parametrize("projection_axis", [0, 1, 2])
@pytest.mark.parametrize("path", ["rowgather", "general"])
def test_plain_matches_jax(path, projection_axis, n):
    projs, minv, keep = _series(SHAPE, projection_axis, n, path,
                                seed=10 * projection_axis + n)
    rowgather = bp.row_gather(minv, keep, SHAPE, projs.shape[1:])
    assert rowgather == (path == "rowgather")
    got = bp.plain_backproject(torch.from_numpy(projs), minv, keep, SHAPE)
    assert got.shape == SHAPE and got.dtype == torch.float32
    _close(got.numpy(), _jax(minv, keep, SHAPE, projs, minv))
    # the model's adjoint is the same function
    adj = _make_adjoint(minv, keep, SHAPE, projs.shape[1:])
    assert torch.equal(adj(torch.from_numpy(projs), minv), got)


@pytest.mark.parametrize("projection_axis", [0, 2])
@pytest.mark.parametrize("path", ["rowgather", "general"])
def test_plain_matches_jax_on_shifted_slabs(path, projection_axis):
    """A volume shard's call: its slab of planes, the slab offset folded
    into column 3 of M^-1, the path decided on the unshifted matrices (as
    ``wbp_reconstruct(mesh_shard='volume')`` and the mesh SIRT do, in both
    packages)."""
    projs, minv, keep = _series(SHAPE, projection_axis, 7, path, seed=3)
    local = 4
    slab = (local,) + SHAPE[1:]
    rowgather = bp.row_gather(minv, keep, SHAPE, projs.shape[1:])
    pieces = []
    for i in range(-(-SHAPE[0] // local)):
        mv = _shifted(minv, np.float32(i * local))
        got = bp.plain_backproject(torch.from_numpy(projs), mv, keep, slab,
                                   rowgather)
        _close(got.numpy(), _jax(minv, keep, slab, projs, mv))
        pieces.append(got)
    # the slabs tile the single-device volume
    whole = bp.plain_backproject(torch.from_numpy(projs), minv, keep, SHAPE)
    _close(torch.cat(pieces)[:SHAPE[0]].numpy(), whole.numpy())


@pytest.mark.parametrize("path", ["rowgather", "general"])
def test_plain_matches_jax_off_the_projection(path):
    """Rows partly and wholly outside the projection, on both sides: the
    taps out of range count 0."""
    projs, minv, keep = _series(SHAPE, 0, 5, path, seed=8)
    h = projs.shape[1]
    minv[0, keep[0], 3] += np.float32(h - 2.5)
    minv[1, keep[0], 3] -= np.float32(h - 1.75)
    minv[2, keep[0], 3] += np.float32(3 * h)
    if path == "general":
        minv[3, keep[1], 3] -= np.float32(projs.shape[2] - 0.5)
    got = bp.plain_backproject(torch.from_numpy(projs), minv, keep, SHAPE)
    want = _jax(minv, keep, SHAPE, projs, minv)
    _close(got.numpy(), want)
    # the tilt wholly off the projection adds nothing
    alone = bp.plain_backproject(torch.from_numpy(projs[2:3]), minv[2:3],
                                 keep, SHAPE)
    assert not alone.any()


def test_forced_general_path_matches_jax_and_the_row_gather_path():
    projs, minv, keep = _series(SHAPE, 0, 7, "rowgather", seed=5)
    t = torch.from_numpy(projs)
    general = bp.plain_backproject(t, minv, keep, SHAPE, rowgather=False)
    _close(general.numpy(), _jax(minv, keep, SHAPE, projs, minv,
                                 force_general=True))
    _close(general.numpy(), bp.plain_backproject(t, minv, keep,
                                                 SHAPE).numpy())


def _geometries():
    """(name, minv, keep, out_shape, proj_shape) spanning the decision:
    tilt series about each axis, random rotations, perturbations on both
    sides of its 1e-6 thresholds, and mismatched widths."""
    cases = []
    for p in range(3):
        keep = [a for a in range(3) if a != p]
        for path in ("rowgather", "general"):
            projs, minv, _ = _series(SHAPE, p, 5, path, seed=p)
            proj_shape = projs.shape[1:]
            cases.append((f"{path}_axis{p}", minv, keep, SHAPE, proj_shape))
            wide = (proj_shape[0], proj_shape[1] + 1)
            cases.append((f"{path}_axis{p}_wider", minv, keep, SHAPE, wide))
        _, minv, _ = _series(SHAPE, p, 5, "rowgather", seed=p)
        proj_shape = (SHAPE[keep[0]], SHAPE[keep[1]])
        for eps in (2e-7, 4e-6):
            for r, c in ((keep[1], 0), (keep[1], 3), (keep[0], keep[1])):
                m = minv.copy()
                m[2, r, c] += np.float32(eps)
                cases.append((f"axis{p}_{r}{c}_{eps}", m, keep, SHAPE,
                              proj_shape))
    rng = np.random.default_rng(0)
    for k in range(3):
        m = np.linalg.inv(_rotation(SHAPE, 0, rng.uniform(-90, 90))
                          @ _rotation(SHAPE, 1, rng.uniform(-90, 90))
                          ).astype(np.float32)[None]
        cases.append((f"random{k}", m, [1, 2], SHAPE, SHAPE[1:]))
    return cases


@pytest.mark.parametrize("force_general", [False, True])
def test_row_gather_decision_is_the_jax_one(force_general):
    for name, minv, keep, out_shape, proj_shape in _geometries():
        want = _jax_rowgather(minv, keep, out_shape, proj_shape,
                              force_general)
        got = bp.row_gather(minv, keep, out_shape, proj_shape,
                            force_general)
        assert got == bool(want), name
    # both outcomes occur
    outcomes = {bp.row_gather(*case[1:]) for case in _geometries()}
    assert outcomes == {True, False}


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    projs, minv, keep = _series(SHAPE, 1, 7, "rowgather", seed=2)
    t = torch.from_numpy(projs)
    before = _build.launches()["backproject"]
    for rowgather in (None, True, False):
        got = bp.backproject(t, minv, keep, SHAPE, rowgather)
        assert got.is_contiguous() and got.dtype == torch.float32
        assert torch.equal(got, bp.plain_backproject(t, minv, keep, SHAPE,
                                                     rowgather))
    assert _build.launches()["backproject"] == before


def test_wrapper_checks():
    projs, minv, keep = _series(SHAPE, 0, 3, "rowgather", seed=1)
    t = torch.from_numpy(projs)
    with pytest.raises(ValueError, match="N = 3"):
        bp.backproject(t, minv[:2], keep, SHAPE)
    with pytest.raises(ValueError, match="N = 2"):
        bp.backproject(t[:2], minv, keep, SHAPE)
    with pytest.raises(ValueError, match="float32"):
        bp.backproject(t.double(), minv, keep, SHAPE)
    with pytest.raises(ValueError, match="float32"):
        bp.backproject(t, minv.astype(np.float64), keep, SHAPE)
    with pytest.raises(ValueError, match="contiguous"):
        bp.backproject(t.transpose(1, 2).contiguous().transpose(1, 2),
                       minv, keep, SHAPE)
    with pytest.raises(ValueError, match=r"\(N, H', W'\)"):
        bp.backproject(t[0], minv[:1], keep, SHAPE)
    with pytest.raises(ValueError, match="non-empty"):
        bp.backproject(t[:0], minv[:0], keep, SHAPE)
    with pytest.raises(TypeError):
        bp.backproject(projs, minv, keep, SHAPE)
    with pytest.raises(ValueError, match="keep"):
        bp.backproject(t, minv, [2, 1], SHAPE)
    with pytest.raises(ValueError, match="out_shape"):
        bp.backproject(t, minv, keep, SHAPE[:2])
    with pytest.raises(ValueError, match="as wide"):
        bp.backproject(t, minv, keep, SHAPE[:2] + (SHAPE[2] + 1,), True)
    with pytest.raises(ValueError, match="unsupported device"):
        bp.backproject(t.to("meta"), minv, keep, SHAPE)


def _emulate(projs, table, keep, out_shape, rowgather):
    """The kernel's per-voxel loop in torch, from its coefficient table:
    each output voxel (z, y, x) maps straight to its indices (no permute),
    validity is tested on the float floor, the taps are read at flat
    offsets of the projection, and every operation is rounded on its own
    in the kernel's order."""
    n, h, w = projs.shape
    flat = projs.reshape(n, h * w)
    idx = [torch.arange(s).view([s if a == b else 1 for b in range(3)])
           for a, s in enumerate(out_shape)]
    fidx = [i.to(torch.float32) for i in idx]
    acc = torch.zeros(out_shape, dtype=torch.float32)

    def read(t, valid, row, col):
        offset = torch.where(valid, row * w + col, 0)
        return torch.where(valid, flat[t][offset], 0.0)

    for t in range(n):
        c = [float(v) for v in table[t]]
        if rowgather:
            dep = [a for a in range(3) if a != keep[1]]
            rows = (c[0] * fidx[dep[0]] + c[1] * fidx[dep[1]]) + c[2]
            r0f = torch.floor(rows)
            fr = rows - r0f
            w0 = 1.0 - fr
            v0 = (r0f >= 0) & (r0f < h)
            v1 = (r0f >= -1) & (r0f < h - 1)
            r0 = torch.where(v0 | v1, r0f, 0.0).to(torch.int64)
            col = idx[keep[1]]
            gb = read(t, v0, r0, col) * w0 + read(t, v1, r0 + 1, col) * fr
            acc = acc + gb
        else:
            rows = ((c[0] * fidx[0] + c[1] * fidx[1]) + c[2] * fidx[2]) \
                + c[3]
            cols = ((c[4] * fidx[0] + c[5] * fidx[1]) + c[6] * fidx[2]) \
                + c[7]
            y0f, x0f = torch.floor(rows), torch.floor(cols)
            ty, tx = rows - y0f, cols - x0f
            uy, ux = 1.0 - ty, 1.0 - tx
            vy0 = (y0f >= 0) & (y0f < h)
            vy1 = (y0f >= -1) & (y0f < h - 1)
            vx0 = (x0f >= 0) & (x0f < w)
            vx1 = (x0f >= -1) & (x0f < w - 1)
            iy = torch.where(vy0 | vy1, y0f, 0.0).to(torch.int64)
            ix = torch.where(vx0 | vx1, x0f, 0.0).to(torch.int64)
            t00 = read(t, vy0 & vx0, iy, ix) * (uy * ux)
            t01 = read(t, vy0 & vx1, iy, ix + 1) * (uy * tx)
            t10 = read(t, vy1 & vx0, iy + 1, ix) * (ty * ux)
            t11 = read(t, vy1 & vx1, iy + 1, ix + 1) * (ty * tx)
            acc = acc + (((t00 + t01) + t10) + t11)
    return acc


@pytest.mark.parametrize("shape", [SHAPE, (9, 16, 8)])
@pytest.mark.parametrize("projection_axis", [0, 1, 2])
@pytest.mark.parametrize("path", ["rowgather", "general"])
def test_coefficient_table_reproduces_the_plain_version(path,
                                                        projection_axis,
                                                        shape):
    projs, minv, keep = _series(shape, projection_axis, 7, path,
                                seed=projection_axis)
    # rows far off the projection on both sides (int32 would wrap at 1e10)
    minv[1, keep[0], 3] = np.float32(1e10)
    minv[2, keep[0], 3] = np.float32(-1e10)
    rowgather = path == "rowgather"
    table = bp.coefficients(minv, keep, rowgather)
    assert table.dtype == np.float32 and table.flags.c_contiguous
    assert table.shape == (7, 4 if rowgather else 8)
    t = torch.from_numpy(projs)
    want = bp.plain_backproject(t, minv, keep, shape, rowgather)
    assert torch.equal(_emulate(t, table, keep, shape, rowgather), want)
    # and a volume shard's shifted matrices
    mv = _shifted(minv, np.float32(4))
    want = bp.plain_backproject(t, mv, keep, shape, rowgather)
    assert torch.equal(
        _emulate(t, bp.coefficients(mv, keep, rowgather), keep, shape,
                 rowgather), want)

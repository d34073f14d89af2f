"""The back-projection C's row-gather tiles on the CPU, and the port's
version.

The row-gather kernel (``csrc/backproject.cu``, card only) gives each CTA a
tile of lines (``warps`` along dep0 by ``lines`` along dep1); for each tilt
it stages the projection rows that the tile reads (its window) in shared
memory and reads every tap from there.  The host sizes the tile
(``kernels/backproject.py::rowgather_tile``).  Here, a plain emulation of
the kernel's window (the rows expression at the tile's four corners,
rounded as the kernel rounds it, floored, clipped to the projection before
any int conversion) and of its staged sum (a window of ``cap`` rows from
its first row, rows past the projection zero, as TMA fills them) is held:

* under hypothesis, over random tilt series about each axis, the four
  shifted slabs of a 4-shard mesh, rows shifted up to +-h/2 and +-1e10,
  odd shapes, one tilt and scaled row-gather matrices: every valid tap of
  every voxel lies inside its tile's window, with the tile the host picks;
* bit for bit (``torch.equal``) against ``plain_backproject``, and against
  the JAX package's ``_make_adjoint`` at the tolerance of
  ``tests/test_torch_backproject.py`` (atol 1e-5 of the largest |value|);
* with a window capped below the tile's need: the taps outside it are
  counted as misses, read from the projection, and the sum stays exact.

Also: ``voltools_tpu_torch.__version__`` is the JAX package's, and the
port's ``__all__`` holds every name of the JAX package's.
"""

import importlib
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import voltools_tpu
import voltools_tpu_torch
from voltools_tpu.models.reconstruction import _make_adjoint as jax_adjoint
from voltools_tpu_torch.kernels import backproject as bp
from voltools_tpu_torch.parallel.sharded import _shifted

REPO = Path(__file__).resolve().parent.parent
RTOL_OF_MAX = 1e-5
SHARDS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread per test process keeps parallel
    test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_version_is_the_jax_packages():
    assert voltools_tpu_torch.__version__ == voltools_tpu.__version__
    assert voltools_tpu_torch.__version__ == "0.6.0"
    text = (REPO / "pyproject.toml").read_text()
    assert re.search(r'^version = "0\.6\.0"$', text, re.M)
    assert "__version__" in voltools_tpu_torch.__all__


def test_all_holds_every_name_of_the_jax_package():
    """Every public name of the JAX package is the port's too, apart from
    the TPU-only ``select_variant``; the port's further names are
    subpackages the JAX package has as well."""
    jax_all = set(voltools_tpu.__all__) - {"select_variant"}
    port_all = set(voltools_tpu_torch.__all__)
    assert jax_all <= port_all
    for name in port_all:
        getattr(voltools_tpu_torch, name)
    for name in port_all - jax_all:
        importlib.import_module(f"voltools_tpu.{name}")


def _rotation(shape, axis, degrees):
    """The pull-back matrix of a rotation about array ``axis`` by
    ``degrees`` about the volume's centre (float64)."""
    i, j = [a for a in range(3) if a != axis]
    c, s = np.cos(np.radians(degrees)), np.sin(np.radians(degrees))
    m = np.eye(4)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    centre = (np.asarray(shape, np.float64) - 1) / 2
    m[:3, 3] = centre - m[:3, :3] @ centre
    return m


def _series(shape, projection_axis, angles, scale=1.0, shifts=None):
    """float32 M^-1 of a single-axis tilt series about the projection's
    column axis keep[1] (the row-gather geometry), the rows coordinate
    scaled by ``scale`` and shifted per tilt by ``shifts``; and keep."""
    keep = [a for a in range(3) if a != projection_axis]
    minv = np.stack([np.linalg.inv(_rotation(shape, keep[1], a))
                     for a in angles]).astype(np.float32)
    dep = [a for a in range(3) if a != keep[1]]
    minv[:, keep[0], dep] *= np.float32(scale)
    if shifts is not None:
        minv[:, keep[0], 3] += np.asarray(shifts, np.float32)
    return minv, keep


def _projections(n, shape, keep, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.random((n, shape[keep[0]], shape[keep[1]])).astype(np.float32)
        - np.float32(0.25))


def _lines(out_shape, keep):
    """(n0, n1, dep1): the output's lines along dep0 and dep1."""
    dep1 = 1 if keep[1] == 2 else 2
    return out_shape[0], out_shape[dep1], dep1


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _rows(r, f0, f1):
    """The kernel's rows expression ((r_dep0 f0) + (r_dep1 f1)) + r3, every
    operation rounded in float32."""
    return (_f32(r[0]) * f0 + _f32(r[1]) * f1) + _f32(r[2])


def tile_windows(r, tile, n0, n1, h):
    """The first row ``lo`` of each tile's window for one tilt's table row
    ``r``, and whether any row of its taps lies on the projection: the
    rows expression at the tile's four corners (clipped to the output),
    floored; the lowest and the highest plus one, clipped to [0, h) in
    float (fmin and fmax ignore NaN, as CUDA's do).  Shapes (tiles along
    dep0, tiles along dep1)."""
    warps, lines = tile.warps, tile.lines
    i0s = torch.arange(0, n0, warps, dtype=torch.float32)
    i1s = torch.arange(0, n1, lines, dtype=torch.float32)
    f0a, f0b = i0s[:, None], torch.clamp(i0s + warps, max=n0)[:, None] - 1
    f1a, f1b = i1s[None, :], torch.clamp(i1s + lines, max=n1)[None, :] - 1
    q = [torch.floor(_rows(r, f0, f1)) for f0 in (f0a, f0b)
         for f1 in (f1a, f1b)]
    low = torch.fmax(torch.fmin(torch.fmin(q[0], q[1]),
                                torch.fmin(q[2], q[3])), _f32(0.0))
    high = torch.fmin(torch.fmax(torch.fmax(q[0], q[1]),
                                 torch.fmax(q[2], q[3])) + _f32(1.0),
                      _f32(h - 1))
    some = low <= high
    return torch.where(some, low, _f32(0.0)).to(torch.int64), some


def line_taps(r, n0, n1, h):
    """Each line's (1 - fr, fr, r0, valid0, valid1) for one tilt, as the
    kernel's line table computes them; r0 converted only where a tap is
    valid."""
    j0 = torch.arange(n0, dtype=torch.float32)[:, None]
    j1 = torch.arange(n1, dtype=torch.float32)[None, :]
    rows = _rows(r, j0, j1)
    r0f = torch.floor(rows)
    fr = rows - r0f
    v0 = (r0f >= 0) & (r0f < h)
    v1 = (r0f >= -1) & (r0f < h - 1)
    r0 = torch.where(v0 | v1, r0f, _f32(0.0)).to(torch.int64)
    return _f32(1.0) - fr, fr, r0, v0, v1


def window_misses(minv, keep, out_shape, h, tile=None):
    """The taps (per line, so a line's columns count once) that lie on the
    projection but outside their tile's window, over all tilts, with the
    host's tile (or ``tile``)."""
    n0, n1, _ = _lines(out_shape, keep)
    table = bp.coefficients(minv, keep, True)
    if tile is None:
        tile = bp.rowgather_tile(table, n0, n1, h)
    t0 = torch.arange(n0)[:, None] // tile.warps
    t1 = torch.arange(n1)[None, :] // tile.lines
    misses = 0
    for r in table:
        lo, _ = tile_windows(r, tile, n0, n1, h)
        lo = lo[t0, t1]
        _, _, r0, v0, v1 = line_taps(r, n0, n1, h)
        for row, valid in ((r0, v0), (r0 + 1, v1)):
            inside = (row >= lo) & (row - lo < tile.cap)
            misses += int((valid & ~inside).sum())
    return misses, tile


def staged_backproject(projs, minv, keep, out_shape, tile=None):
    """The row-gather kernel's sum from its staged windows: each tile's
    window (``cap`` rows from its first, rows past the projection zero)
    copied out of the projection, each valid tap read from it where it
    lies inside and from the projection (counted) where not, an invalid
    tap 0; acc = acc + ((g0 * w0) + (g1 * fr)) tilt after tilt.  Returns
    (volume, taps read outside the window, tile)."""
    n, h, w = projs.shape
    n0, n1, dep1 = _lines(out_shape, keep)
    table = bp.coefficients(minv, keep, True)
    if tile is None:
        tile = bp.rowgather_tile(table, n0, n1, h)
    t0 = torch.arange(n0)[:, None] // tile.warps
    t1 = torch.arange(n1)[None, :] // tile.lines
    acc = torch.zeros((n0, n1, w), dtype=torch.float32)
    misses = 0
    for t, r in enumerate(table):
        lo, some = tile_windows(r, tile, n0, n1, h)
        rows = lo[..., None] + torch.arange(tile.cap)
        window = torch.where((rows < h)[..., None],
                             projs[t][rows.clamp(max=h - 1)], _f32(0.0))
        # a tile with no row on the projection stages nothing
        window = torch.where(some[..., None, None], window, _f32(np.nan))
        lo = lo[t0, t1]
        w0, fr, r0, v0, v1 = line_taps(r, n0, n1, h)
        taps = []
        for row, valid in ((r0, v0), (r0 + 1, v1)):
            inside = (row >= lo) & (row - lo < tile.cap)
            staged = window[t0, t1, (row - lo).clamp(0, tile.cap - 1)]
            direct = projs[t][row.clamp(0, h - 1)]
            misses += int((valid & ~inside).sum()) * w
            taps.append(torch.where(
                valid[..., None],
                torch.where(inside[..., None], staged, direct), _f32(0.0)))
        acc = acc + (taps[0] * w0[..., None] + taps[1] * fr[..., None])
    perm = tuple(int(i) for i in np.argsort([0, dep1, keep[1]]))
    return acc.permute(perm).contiguous(), misses, tile


def _close(got, want):
    atol = RTOL_OF_MAX * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


ANGLES = np.linspace(-60.0, 60.0, 7)
SHAPES = [(11, 14, 17), (9, 16, 8), (37, 50, 61)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("projection_axis", [0, 1, 2])
def test_staged_sum_equals_plain_and_jax(shape, projection_axis):
    """The tile the host picks, its windows and staged sum: no miss, bit
    for bit the plain version, and the JAX adjoint within its atol."""
    minv, keep = _series(shape, projection_axis, ANGLES)
    h = shape[keep[0]]
    minv[-1, keep[0], 3] += np.float32(0.4 * h)      # partly off
    minv[2, keep[0], 3] = np.float32(1e10)            # wholly off, above
    minv[3, keep[0], 3] = np.float32(-1e10)           # and below
    projs = _projections(len(ANGLES), shape, keep, seed=sum(shape))
    got, misses, tile = staged_backproject(projs, minv, keep, shape)
    assert misses == 0 and tile[:2] == bp.TILES[0]
    want = bp.plain_backproject(projs, minv, keep, shape, True)
    assert torch.equal(got, want)
    jax = np.asarray(jax_adjoint(minv, keep, shape, tuple(projs.shape[1:]))(
        projs.numpy(), minv))
    _close(got.numpy(), jax)


@pytest.mark.parametrize("slab", range(SHARDS))
def test_staged_sum_on_the_shifted_slabs_of_a_4_shard_mesh(slab):
    shape = (37, 50, 61)
    minv, keep = _series(shape, 0, ANGLES)
    local = -(-shape[0] // SHARDS)
    mv = _shifted(minv, np.float32(slab * local))
    slab_shape = (local,) + shape[1:]
    projs = _projections(len(ANGLES), shape, keep, seed=slab)
    got, misses, _ = staged_backproject(projs, mv, keep, slab_shape)
    assert misses == 0
    assert torch.equal(got, bp.plain_backproject(projs, mv, keep,
                                                 slab_shape, True))
    jax = np.asarray(jax_adjoint(minv, keep, slab_shape,
                                 tuple(projs.shape[1:]))(projs.numpy(), mv))
    _close(got.numpy(), jax)


def test_staged_sum_of_one_tilt():
    shape = (9, 16, 8)
    minv, keep = _series(shape, 0, [23.0])
    projs = _projections(1, shape, keep, seed=1)
    got, misses, _ = staged_backproject(projs, minv, keep, shape)
    assert misses == 0
    assert torch.equal(got, bp.plain_backproject(projs, minv, keep, shape,
                                                 True))


@pytest.mark.parametrize("scale", [3.0, 30.0])
def test_a_large_span_takes_a_smaller_tile_and_stays_exact(scale):
    """A scaled row-gather matrix: a tile's rows span more than its
    window can hold at 4 x 8 lines (at 30x), so the host picks a smaller
    tile; the staged sum has no miss and equals the plain version."""
    shape = (40, 250, 24)
    minv, keep = _series(shape, 0, ANGLES, scale=scale)
    assert bp.row_gather(minv, keep, shape, (shape[1], shape[2]))
    projs = _projections(len(ANGLES), shape, keep, seed=4)
    got, misses, tile = staged_backproject(projs, minv, keep, shape)
    assert misses == 0
    assert bp.smem_bytes(*tile) <= bp.SMEM_LIMIT
    if scale == 30.0:
        assert tile[:2] != bp.TILES[0]
    assert torch.equal(got, bp.plain_backproject(projs, minv, keep, shape,
                                                 True))


@pytest.mark.parametrize("tile", [bp.RowTile(8, 8, 2), bp.RowTile(2, 1, 1),
                                  bp.RowTile(8, 1, 3)])
def test_a_capped_window_counts_its_misses_and_stays_exact(tile):
    """Windows capped below the tile's need: the taps outside are read
    from the projection and counted; the sum is still the plain one."""
    shape = (11, 14, 17)
    minv, keep = _series(shape, 0, np.linspace(-60.0, 60.0, 5))
    projs = _projections(5, shape, keep, seed=7)
    got, misses, _ = staged_backproject(projs, minv, keep, shape, tile)
    assert misses > 0
    assert misses == window_misses(minv, keep, shape, 14, tile)[0] * 17
    assert torch.equal(got, bp.plain_backproject(projs, minv, keep, shape,
                                                 True))


def test_the_reconstruction_series_takes_the_first_tile():
    """The 41-tilt series at 250^3: the 4 x 8 tile, 10 rows a window (the
    tile's rows span at most 3 |sin a| + 7 cos a = 7.6 lines, at a = 24
    degrees), and no miss."""
    shape = (250, 250, 250)
    minv, keep = _series(shape, 0, np.arange(-60.0, 61.0, 3.0))
    table = bp.coefficients(minv, keep, True)
    tile = bp.rowgather_tile(table, 250, 250, 250)
    assert tile == bp.RowTile(4, 8, 10)
    assert bp.smem_bytes(*tile) <= 30 * 1024
    assert window_misses(minv[::8], keep, shape, 250)[0] == 0


def test_window_rows_bounds_and_fallback():
    """The span bound: a tilt whose rows lie off the projection over the
    whole output stages nothing, non-finite coefficients stage the whole
    projection, and a span no tile can hold falls back to the one-line
    tile with as many rows as fit."""
    shape = (20, 30, 40)
    minv, keep = _series(shape, 0, [10.0])
    table = bp.coefficients(minv, keep, True)
    assert 0 < bp.window_rows(table, 8, 8, 20, 30, 30) <= 30
    off = table.copy()
    off[:, 2] = np.float32(1e10)
    assert bp.window_rows(off, 8, 8, 20, 30, 30) == 0
    nan = table.copy()
    nan[:, 0] = np.float32(np.nan)
    assert bp.window_rows(nan, 8, 8, 20, 30, 30) == 30
    huge = table.copy()
    huge[:, :2] *= np.float32(1e8)
    tile = bp.rowgather_tile(huge, 20, 30, 5000)
    fit = (bp.SMEM_LIMIT - bp.smem_bytes(1, 1, 0)) // (8 * bp.TILE_COLUMNS)
    assert tile == bp.RowTile(1, 1, min(fit, bp.MAX_CAP))
    assert bp.smem_bytes(*tile) <= bp.SMEM_LIMIT


def test_host_constants_are_the_kernels():
    """The kernel's layout is the wrapper's ``LAYOUT``: the source takes
    every entry as a macro and states none of them itself, the build
    passes them as ``-D`` flags (another layout is another library), and
    the host's tiles and shared memory follow from them."""
    from voltools_tpu_torch.kernels import _build
    src = (REPO / "voltools_tpu_torch" / "csrc" / "backproject.cu") \
        .read_text()
    for macro, value in bp.LAYOUT.items():
        assert re.search(rf"constexpr int k\w+ = {macro};", src), macro
        assert f"-D{macro}={value}" in _build.flags(bp.LAYOUT)
    assert not re.search(r"constexpr int k(Pairs|Stages|Lines|MaxCap|Align"
                         r"|MaxTileWarps) = \d", src)
    other = {**bp.LAYOUT, "BP_STAGES": 3}
    assert _build.library_path(bp.NAME, bp.LAYOUT) != \
        _build.library_path(bp.NAME, other)
    assert _build.flags(None) == _build.NVCC_FLAGS
    assert bp.TILE_COLUMNS == 64 * bp.LAYOUT["BP_PAIRS"]
    assert {lines for _, lines in bp.TILES} == {1, bp.LAYOUT["BP_LINES"]}
    assert {warps for warps, _ in bp.TILES} == {1, 2, 4,
                                                bp.LAYOUT["BP_WARPS"]}
    assert bp.smem_bytes(8, 8, 12) == 128 + 4 * 25 * 256 + 16 * 2 * 64
    assert bp.smem_bytes(8, 8, 12, other) == \
        128 + 4 * 37 * 256 + 16 * 3 * 64


PTXAS_LOG = """\
ptxas info    : 11 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116rowgather_kernelILi1EEEv14CUtensorMap_stNS_9RowGatherE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116rowgather_kernelILi1EEEv14CUtensorMap_stNS_9RowGatherE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 16 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116rowgather_kernelILi8EEEv14CUtensorMap_stNS_9RowGatherE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116rowgather_kernelILi8EEEv14CUtensorMap_stNS_9RowGatherE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes smem
"""


@pytest.mark.parametrize("entry, usage", [
    ("rowgather_kernelILi1E", (40, 0)), ("rowgather_kernelILi8E", (128, 4)),
    ("general_kernel", None)])
def test_ptxas_usage_reads_an_entrys_registers(entry, usage):
    """The registers and spills the timing phase reports come from nvcc's
    ``-Xptxas -v`` lines of the entry function named."""
    from voltools_tpu_torch.kernels import _build
    assert _build.ptxas_usage(PTXAS_LOG, entry) == usage


# geometries of the property: a tilt series about the projection's column
# axis, with per-tilt angles, rows shifts, a scale and an optional slab
SHAPE_CHOICES = [(11, 14, 17), (9, 16, 8), (37, 50, 61), (20, 3, 37),
                 (1, 9, 10), (6, 1, 140)]


@st.composite
def geometries(draw):
    shape = draw(st.sampled_from(SHAPE_CHOICES))
    axis = draw(st.integers(0, 2))
    n = draw(st.integers(1, 6))
    angles = draw(st.lists(st.floats(-75.0, 75.0), min_size=n, max_size=n))
    keep = [a for a in range(3) if a != axis]
    h = shape[keep[0]]
    shift = st.one_of(st.floats(-h / 2, h / 2),
                      st.sampled_from([1e10, -1e10, 0.0]))
    shifts = draw(st.lists(shift, min_size=n, max_size=n))
    scale = draw(st.sampled_from([1.0, 1.0, 0.5, 3.0, 30.0]))
    slab = draw(st.one_of(st.none(), st.integers(0, SHARDS - 1)))
    return shape, axis, angles, shifts, scale, slab


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(geometries())
def test_every_valid_tap_lies_in_its_tiles_window(geometry):
    shape, axis, angles, shifts, scale, slab = geometry
    minv, keep = _series(shape, axis, angles, scale, shifts)
    out_shape = shape
    if slab is not None:
        local = -(-shape[0] // SHARDS)
        minv = _shifted(minv, np.float32(slab * local))
        out_shape = (local,) + shape[1:]
    assert bp.row_gather(minv, keep, shape, (shape[keep[0]],
                                             shape[keep[1]]))
    misses, tile = window_misses(minv, keep, out_shape, shape[keep[0]])
    assert misses == 0, tile
    assert 1 <= tile.cap <= bp.MAX_CAP
    assert bp.smem_bytes(*tile) <= bp.SMEM_LIMIT

"""Template matching (``voltools_tpu_torch.TemplateMatcher``) against the
benchmark's float64 reference (``portbench/reference/matching.py``), and
the reference against a direct sum, at a small size on the CPU: a
(24, 40, 36) tomogram, a 12^3 template, a spherical mask of radius 5.

The card test (marker ``cuda``, skipped without a CUDA device) imports no
JAX; on the card's machine::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_matching.py -q
"""

import math

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.reference import matching as reference
from portbench.reference import matching_nsmask as reference_nsmask
from portbench.reference import resample
from voltools_tpu_torch import TemplateMatcher
from voltools_tpu_torch.kernels.match_zpass import window
from voltools_tpu_torch.models import missing_wedge
from voltools_tpu_torch.utils import trace

SHAPE = (24, 40, 36)
BOX = 12
C = BOX // 2
RADIUS = 5.0


def _mask(radius=RADIUS, edge=1.0, stretch=(1.0, 1.0, 1.0), centre=C):
    g = [(np.arange(BOX) - centre) * s for s in stretch]
    r = np.sqrt(g[0][:, None, None] ** 2 + g[1][None, :, None] ** 2
                + g[2][None, None, :] ** 2)
    return np.where(r <= radius, 1.0,
                    np.exp(-0.5 * ((r - radius) / edge) ** 2)).astype(
                        np.float32)


def _blobs(rng, shape, n, sigma, spread):
    """``n`` Gaussian blobs of ``sigma`` voxels within ``spread`` of the
    centre of ``shape``, float32."""
    axes = [np.arange(s, dtype=np.float64) for s in shape]
    vol = np.zeros(shape)
    for _ in range(n):
        c = [s / 2 + rng.uniform(-spread, spread) for s in shape]
        prof = [np.exp(-0.5 * ((a - ci) / sigma) ** 2)
                for a, ci in zip(axes, c)]
        vol += prof[0][:, None, None] * prof[1][None, :, None] \
            * prof[2][None, None, :]
    return vol.astype(np.float32)


def _data(seed=20251018, orientations=8):
    rng = np.random.default_rng(seed)
    template = _blobs(rng, (BOX,) * 3, 4, 1.5, 3.0)
    tomogram = (_blobs(rng, SHAPE, 12, 2.5, 10.0)
                + 0.05 * rng.standard_normal(SHAPE)).astype(np.float32)
    ms = traffic.rotation_pool(rng, orientations, (BOX,) * 3)
    return tomogram, template, _mask(), ms


def _reference(tomogram, template, mask, ms, **kw):
    return reference.match(torch.from_numpy(tomogram),
                           torch.from_numpy(template),
                           torch.from_numpy(mask), ms, **kw)


GEOMETRIES = [dict(), dict(tilt_range=(-45.0, 70.0)),
              dict(tilt_axis=0, projection_axis=2),
              dict(interpolation="linear")]


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_matcher_agrees_with_the_reference(geometry):
    tomogram, template, mask, ms = _data()
    tm = TemplateMatcher(tomogram, template, mask, device="cpu", **geometry)
    tm.match(ms)
    scores, indices = tm.result()
    best, index, second = _reference(tomogram, template, mask, ms,
                                     **geometry)
    best, index = best.numpy(), index.numpy()
    # float32 transforms against float64: 1e-4 of the largest score
    assert np.abs(scores - best).max() <= 1e-4 * np.abs(best).max()
    clear = (best - second.numpy()) > 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(indices[clear], index[clear])
    assert indices.dtype == np.int32 and scores.dtype == np.float32


def _direct_score(tomogram, t_hat, mask, x):
    """sum_y T(y) V(x + y - c) / (n sigma(x)), sigma under the mask placed
    the same way, by sums over the box in float64 with no transform."""
    v = tomogram.astype(np.float64)
    idx = [(x[a] + np.arange(BOX) - C) % SHAPE[a] for a in range(3)]
    window = v[np.ix_(*idx)]
    m = mask.astype(np.float64)
    n = m.sum()
    mean = (m * window).sum() / n
    sigma = math.sqrt((m * window ** 2).sum() / n - mean ** 2)
    return (t_hat * window).sum() / (n * sigma)


@pytest.mark.parametrize("voxel", [(0, 0, 0), (12, 20, 18), (23, 1, 35),
                                   (5, 39, 7)])
def test_reference_score_is_the_direct_sum(voxel):
    tomogram, template, mask, ms = _data(orientations=1)
    best, index, _ = _reference(tomogram, template, mask, ms)
    assert (index == 0).all()
    # the normalised template, as the reference makes it
    t = resample.transform(torch.from_numpy(template), ms[0], "filt_bspline")
    w = reference.wedge((BOX,) * 3, (-60.0, 60.0), 2, 0)
    t = torch.fft.irfftn(torch.fft.rfftn(t) * w, s=(BOX,) * 3).numpy()
    m = mask.astype(np.float64)
    mean = (t * m).sum() / m.sum()
    t_hat = m * (t - mean) / math.sqrt(((t - mean) ** 2 * m).sum()
                                       / m.sum())
    want = _direct_score(tomogram, t_hat, mask, voxel)
    assert float(best[voxel]) == pytest.approx(want, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("k,position", [(3, (10, 17, 22)),
                                        (6, (17, 30, 8))])
def test_a_pasted_template_is_found_with_its_index(k, position):
    tomogram, template, mask, ms = _data(orientations=8)
    rng = np.random.default_rng(k)
    tomo = 0.05 * rng.standard_normal(SHAPE).astype(np.float32)
    copy = resample.transform(torch.from_numpy(template), ms[k],
                              "filt_bspline").numpy().astype(np.float32)
    lo = [p - C for p in position]
    tomo[lo[0]:lo[0] + BOX, lo[1]:lo[1] + BOX, lo[2]:lo[2] + BOX] += copy
    tm = TemplateMatcher(tomo, template, mask, device="cpu")
    tm.match(ms)
    scores, indices = tm.result()
    peak = np.unravel_index(np.argmax(scores), SHAPE)
    assert tuple(int(p) for p in peak) == position
    assert indices[position] == k
    assert scores[position] > 0.5


@pytest.mark.parametrize("tilt_axis,projection_axis,box", [
    (2, 0, (12, 12, 12)), (2, 0, (10, 14, 12)), (0, 2, (12, 12, 12)),
    (1, 0, (12, 16, 10))])
def test_wedge_is_its_definition_on_the_rfft_grid(tilt_axis,
                                                   projection_axis, box):
    w = missing_wedge(box, (-60.0, 60.0), tilt_axis, projection_axis)
    assert w.shape == (box[0], box[1], box[2] // 2 + 1)
    assert w.dtype == torch.float32
    k = np.meshgrid(np.fft.fftfreq(box[0]), np.fft.fftfreq(box[1]),
                    np.fft.rfftfreq(box[2]), indexing="ij")
    q = 3 - tilt_axis - projection_axis
    want = np.abs(k[projection_axis]) <= math.tan(math.radians(60.0)) \
        * np.abs(k[q])
    want[0, 0, 0] = True
    np.testing.assert_array_equal(w.numpy() == 1, want)
    assert set(np.unique(w.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(
        w.numpy(), reference.wedge(box, (-60.0, 60.0), tilt_axis,
                                   projection_axis).numpy())


def test_an_asymmetric_wedge_is_the_references():
    box = (12, 16, 10)
    np.testing.assert_array_equal(
        missing_wedge(box, (-40.0, 65.0)).numpy(),
        reference.wedge(box, (-40.0, 65.0), 2, 0).numpy())


def test_reset_and_chunked_calls_are_bit_for_bit_one_call():
    tomogram, template, mask, ms = _data(orientations=7)
    tm = TemplateMatcher(tomogram, template, mask, device="cpu")
    tm.match(ms)
    whole = tm.result(output="device")
    tm.reset()
    assert tm.orientations == 0
    assert bool((tm.result("device")[1] == -1).all())
    assert bool(torch.isinf(tm.result("device")[0]).all())
    tm.match(ms[:3])
    tm.match(ms[3])
    tm.match(ms[4:])
    assert tm.orientations == 7
    for a, b in zip(whole, tm.result(output="device")):
        assert torch.equal(a, b)
    # the snapshot is the caller's: later calls leave it as it was
    before = tm.result(output="device")
    tm.match(ms)
    assert torch.equal(before[1], whole[1])


@pytest.mark.parametrize("mask", [
    _mask(stretch=(1.0, 1.3, 1.0)), _mask(centre=C - 1),
    (np.random.default_rng(3).random((BOX,) * 3) > 0.5).astype(np.float32),
    np.zeros((BOX,) * 3, np.float32)])
def test_a_mask_that_is_not_spherical_is_refused(mask):
    """Only a mask whose weights sum to no more than 0 is refused: a mask
    that is not spherical (stretched, off the centre, random) is scored
    on its own path and agrees with the non-spherical reference."""
    tomogram, template, _, ms = _data()
    if not mask.sum() > 0:
        with pytest.raises(ValueError, match="sum to no more than 0"):
            TemplateMatcher(tomogram, template, mask, device="cpu")
        return
    tm = TemplateMatcher(tomogram, template, mask, device="cpu")
    assert not tm.spherical
    tm.match(ms)
    scores, indices = tm.result()
    best, index, second = (t.numpy() for t in reference_nsmask.match(
        torch.from_numpy(tomogram), torch.from_numpy(template),
        torch.from_numpy(mask), ms))
    assert np.abs(scores - best).max() <= 1e-4 * np.abs(best).max()
    clear = (best - second) > 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(indices[clear], index[clear])


# (tomogram, box): the file's shapes; odd axes with odd and with even
# boxes; a box that is the tomogram on one axis (z, then x); boxes over
# half an axis, up to one line short of it, where the two wrapped slices
# of a window meet
FORWARD_CASES = [((24, 40, 36), (12, 12, 12)), ((23, 39, 35), (11, 13, 9)),
                 ((23, 39, 35), (12, 10, 14)), ((16, 20, 18), (16, 9, 10)),
                 ((24, 40, 36), (10, 12, 36)), ((24, 40, 36), (15, 25, 21)),
                 ((20, 21, 22), (19, 21, 13))]


def _placed_volume(template, shape):
    """The template point-reflected about its centre ``b // 2``, wrapped,
    in a zero volume of ``shape``."""
    idx = [(b // 2 - np.arange(b)) % n
           for b, n in zip(template.shape, shape)]
    volume = np.zeros(shape, np.float32)
    volume[np.ix_(*idx)] = template
    return volume


def _along_z(planes, shape, box, centre):
    """The forward's planes at their z window of zero columns, ``fft``
    along z: the placed volume's ``rfftn``."""
    columns = planes.new_zeros((shape[0],) + tuple(planes.shape[1:]))
    columns.index_copy_(0, window(box[0], centre[0], shape[0],
                                  planes.device), planes)
    return torch.fft.fft(columns, dim=0)


@pytest.mark.parametrize("shape,box", FORWARD_CASES)
def test_the_forward_on_the_templates_lines_is_rfftn_of_the_placed_volume(
        shape, box):
    rng = np.random.default_rng(7)
    tomogram = rng.standard_normal(shape).astype(np.float32)
    template = rng.standard_normal(box).astype(np.float32)
    tm = TemplateMatcher(tomogram, template, np.ones(box, np.float32),
                         device="cpu")
    tm._rows.view(-1).index_copy_(0, tm._place,
                                  torch.from_numpy(template).view(-1))
    # the forward stops at the planes; the spectral pass takes z
    got = _along_z(tm._forward(), shape, box, tm.centre)
    want = torch.fft.rfftn(torch.from_numpy(_placed_volume(template, shape)))
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # what the forward does not write stays zero: a second template
    # leaves no trace of the first
    tm._rows.view(-1).index_copy_(0, tm._place, torch.zeros(
        template.size))
    assert float(tm._forward().abs().max()) == 0.0


def test_the_correlation_comes_back_contiguous_and_counts_its_lines():
    tomogram, template, mask, ms = _data(orientations=3)
    tm = TemplateMatcher(tomogram, template, mask, device="cpu")
    assert tm._correlation().is_contiguous()
    before = trace.counts()
    trace.start()
    try:
        tm.match(ms)
    finally:
        trace.stop()
    after = trace.counts()
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("match.orientations", "match.transforms")}
    assert moved == {"match.orientations": 3, "match.transforms": 6}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_on_the_card_match_queues_without_a_sync_and_agrees(card):
    tomogram, template, mask, ms = _data()
    tm = TemplateMatcher(tomogram, template, mask, device="cuda")
    tm.match(ms[:1])                      # builds kernel A, plans the FFTs
    tm.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.match(ms)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    scores, indices = tm.result()
    best, index, second = _reference(tomogram, template, mask, ms)
    best = best.numpy()
    assert np.abs(scores - best).max() <= 1e-4 * np.abs(best).max()
    clear = (best - second.numpy()) > 1e-3
    np.testing.assert_array_equal(indices[clear], index.numpy()[clear])


@pytest.mark.cuda
def test_on_the_card_the_forward_at_tm512s_shapes_is_rfftn_and_counted(card):
    shape, box = (256, 512, 512), (48, 48, 48)
    gen = torch.Generator(device="cuda").manual_seed(23)
    tomogram = torch.randn(shape, device="cuda", generator=gen)
    template = torch.randn(box, device="cuda", generator=gen)
    tm = TemplateMatcher(tomogram, template, torch.ones(box, device="cuda"))
    del tomogram
    tm._rows.view(-1).index_copy_(0, tm._place, template.view(-1))
    # the forward's planes through the spectral kernel and the inverse
    # along y and x: the correlation of the placed volume's rfftn
    got = tm._correlation()
    assert got.is_contiguous()
    placed = torch.from_numpy(_placed_volume(template.cpu().numpy(), shape))
    want = torch.fft.irfftn(torch.fft.rfftn(placed.cuda()) * tm._spectrum,
                            s=shape, norm="forward")
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    del got, want, placed
    ms = traffic.rotation_pool(np.random.default_rng(23), 4, box)
    before = trace.counts()
    trace.start()
    try:
        tm.match(ms)
    finally:
        trace.stop()
    after = trace.counts()
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("match.orientations", "match.transforms")}
    assert moved == {"match.orientations": 4, "match.transforms": 8}

"""Template matching under a mask that is not spherical
(``voltools_tpu_torch.TemplateMatcher``'s path for pytom-match-pick's
``--non-spherical-mask``) against the benchmark's float64 reference
(``portbench/reference/matching_nsmask.py``), and that reference against
a direct sum and against the fixed-mask reference, at the small size of
``tests/test_torch_matching.py``: a (24, 40, 36) tomogram, a 12^3
template, here an ellipsoidal mask of semi-axes (5, 3.5, 2.5).

On the CPU the maps are those of the former tail of ``_local_inv`` (the
inverses along y and x and the plain passes, kept here), bit for bit.  The
card tests (marker ``cuda``, skipped without a CUDA device) also take the
sigma kernel (``kernels/match_sigma.py``) at widths of each of its designs:
its launches and ``match.local_sigma`` an orientation under the
ellipsoid, none under a sphere, a call that queues without a sync, and a
width past the kernel refused at construction under the ellipsoid only.
They import no JAX; on the card's machine::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_matching_nsmask.py -q
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
from voltools_tpu_torch.kernels import _build
from voltools_tpu_torch.kernels import match_sigma
from voltools_tpu_torch.models import matching
from voltools_tpu_torch.utils import trace

from test_torch_matching import (BOX, C, GEOMETRIES, SHAPE, _blobs, _data,
                                 _direct_score, _mask)

SEMI_AXES = (5.0, 3.5, 2.5)
EDGE = 1.0


def _ellipsoid(semi_axes=SEMI_AXES, edge=EDGE):
    """An ellipsoid about voxel ``C`` with a Gaussian edge in the distance
    outside it along the ray from its centre, float32."""
    g = np.arange(BOX, dtype=np.float64) - C
    axes = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(sum(a ** 2 for a in axes))
    e = np.sqrt(sum((a / s) ** 2 for a, s in zip(axes, semi_axes)))
    outside = r * (1.0 - 1.0 / np.maximum(e, 1.0))
    return np.exp(-0.5 * (outside / edge) ** 2).astype(np.float32)


def _elongated(rng):
    """A template of 4 blobs spread along axis 0: an elongated target."""
    axes = [np.arange(BOX, dtype=np.float64)] * 3
    vol = np.zeros((BOX,) * 3)
    for _ in range(4):
        c = [C + rng.uniform(-s, s) for s in (3.5, 2.0, 1.0)]
        prof = [np.exp(-0.5 * ((a - ci) / 1.3) ** 2)
                for a, ci in zip(axes, c)]
        vol += prof[0][:, None, None] * prof[1][None, :, None] \
            * prof[2][None, None, :]
    return vol.astype(np.float32)


def _reference(tomogram, template, mask, ms, **kw):
    return reference_nsmask.match(torch.from_numpy(tomogram),
                                  torch.from_numpy(template),
                                  torch.from_numpy(mask), ms, **kw)


def _traced(tm, ms, names):
    """``tm.match(ms)`` with the tracer on: the change of its counters
    ``names``, and how many spans of each name it recorded."""
    before = trace.counts()
    trace.start()
    try:
        tm.match(ms)
    finally:
        trace.stop()
    after = trace.counts()
    spans = [e["name"] for e in trace.export()["traceEvents"]
             if e.get("ph") == "X"]
    return ({k: after.get(k, 0) - before.get(k, 0) for k in names},
            {n: spans.count(n) for n in set(spans)})


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_the_matcher_agrees_with_the_non_spherical_reference(geometry):
    tomogram, template, _, ms = _data()
    mask = _ellipsoid()
    tm = TemplateMatcher(tomogram, template, mask, device="cpu", **geometry)
    assert not tm.spherical
    tm.match(ms)
    scores, indices = tm.result()
    best, index, second = (t.numpy() for t in _reference(
        tomogram, template, mask, ms, **geometry))
    # float32 transforms against float64: 1e-4 of the largest score
    assert np.abs(scores - best).max() <= 1e-4 * np.abs(best).max()
    clear = (best - second) > 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(indices[clear], index[clear])
    assert indices.dtype == np.int32 and scores.dtype == np.float32


@pytest.mark.parametrize("voxel", [(0, 0, 0), (12, 20, 18), (23, 1, 35),
                                   (5, 39, 7)])
def test_the_reference_score_is_the_direct_sum_under_the_rotated_mask(
        voxel):
    tomogram, template, _, ms = _data(orientations=1)
    mask = _ellipsoid()
    best, index, _ = _reference(tomogram, template, mask, ms)
    assert (index == 0).all()
    # the rotated mask and the template normalised under it
    coef = resample.prefilter(torch.from_numpy(mask))
    m_r = resample.transform(torch.from_numpy(mask), ms[0], "filt_bspline",
                             coefficients=coef).numpy()
    t = resample.transform(torch.from_numpy(template), ms[0],
                           "filt_bspline")
    w = reference.wedge((BOX,) * 3, (-60.0, 60.0), 2, 0)
    t = torch.fft.irfftn(torch.fft.rfftn(t) * w, s=(BOX,) * 3).numpy()
    mean = (t * m_r).sum() / m_r.sum()
    t_hat = m_r * (t - mean) / math.sqrt(((t - mean) ** 2 * m_r).sum()
                                         / m_r.sum())
    want = _direct_score(tomogram, t_hat, m_r, voxel)
    assert float(best[voxel]) == pytest.approx(want, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("interpolation", ["filt_bspline", "linear"])
def test_at_the_identity_the_reference_is_the_fixed_mask_reference(
        interpolation):
    tomogram, template, _, _ = _data()
    mask = _ellipsoid()
    ms = np.stack([np.eye(4, dtype=np.float32)] * 2)
    got = _reference(tomogram, template, mask, ms,
                     interpolation=interpolation)
    want = reference.match(torch.from_numpy(tomogram),
                           torch.from_numpy(template),
                           torch.from_numpy(mask), ms,
                           interpolation=interpolation)
    scale = float(want[0].abs().max())
    assert float((got[0] - want[0]).abs().max()) <= 1e-6 * scale
    assert torch.equal(got[1], want[1])
    assert (got[1] == 0).all()


@pytest.mark.parametrize("spherical", [True, False])
def test_only_a_mask_that_is_not_spherical_recomputes_sigma(spherical):
    tomogram, template, _, ms = _data(orientations=3)
    mask = _mask() if spherical else _ellipsoid()
    tm = TemplateMatcher(tomogram, template, mask, device="cpu")
    assert tm.spherical == spherical
    assert (tm._inv is not None) == spherical
    moved, spans = _traced(tm, ms, (
        "match.orientations", "match.transforms", "match.local_sigma"))
    assert moved == {"match.orientations": 3,
                     "match.transforms": 3 * (2 if spherical else 5),
                     "match.local_sigma": 0 if spherical else 3}
    assert spans.get("match.sigma", 0) == (0 if spherical else 3)
    assert spans["match.correlate"] == spans["match.update"] == 3


def test_reset_and_chunked_calls_are_bit_for_bit_one_call():
    tomogram, template, _, ms = _data(orientations=7)
    tm = TemplateMatcher(tomogram, template, _ellipsoid(), device="cpu")
    tm.match(ms)
    whole = tm.result(output="device")
    tm.reset()
    assert tm.orientations == 0
    assert bool((tm.result("device")[1] == -1).all())
    tm.match(ms[:3])
    tm.match(ms[3])
    tm.match(ms[4:])
    assert tm.orientations == 7
    for a, b in zip(whole, tm.result(output="device")):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,position", [(3, (10, 17, 22)),
                                        (6, (17, 30, 8))])
def test_a_pasted_elongated_template_is_found_with_its_index(k, position):
    rng = np.random.default_rng(k)
    template = _elongated(rng)
    ms = traffic.rotation_pool(rng, 8, (BOX,) * 3)
    tomo = (0.05 * rng.standard_normal(SHAPE)
            + 0.3 * _blobs(rng, SHAPE, 6, 2.5, 10.0)).astype(np.float32)
    copy = resample.transform(torch.from_numpy(template), ms[k],
                              "filt_bspline").numpy().astype(np.float32)
    lo = [p - C for p in position]
    tomo[lo[0]:lo[0] + BOX, lo[1]:lo[1] + BOX, lo[2]:lo[2] + BOX] += copy
    tm = TemplateMatcher(tomo, template, _ellipsoid((5.5, 3.5, 2.5)),
                         device="cpu")
    tm.match(ms)
    scores, indices = tm.result()
    peak = np.unravel_index(np.argmax(scores), SHAPE)
    assert tuple(int(p) for p in peak) == position
    assert indices[position] == k
    assert scores[position] > 0.5


def _former_local_inv(self, mask, n):
    """``TemplateMatcher._local_inv`` as it was before the sigma kernel:
    the spectral pass, both inverses along y and x, the scale, addcmul_,
    the float32 copy, the floor, rsqrt_ and masked_fill_."""
    self._wide[0].view(-1).index_copy_(0, self._place,
                                       mask.view(-1).double())
    mean, w = self._products(self._forward(self._wide),
                             self._spectrum_wide, self._spectrum_sq_wide)
    mean = matching._irfft_yx(mean, self.shape)
    w = matching._irfft_yx(w, self.shape)
    w.mul_(math.prod(self.shape) * n.double()).addcmul_(
        mean, mean, value=-1.0)
    del mean
    w = w.to(torch.float32)
    low = w <= matching.SIGMA_FLOOR ** 2 * w.max().clamp_min(0.0)
    return w.rsqrt_().masked_fill_(low, 0.0)


@pytest.mark.parametrize("shape", [SHAPE, (16, 20, 128)])
def test_on_the_cpu_the_maps_are_the_former_tail(monkeypatch, shape):
    tomogram, template, _, ms = _data(orientations=4)
    tomogram = np.resize(tomogram, shape).astype(np.float32)
    tm = TemplateMatcher(tomogram, template, _ellipsoid(), device="cpu")
    moved, _ = _traced(tm, ms, ("match.local_sigma",))
    assert moved == {"match.local_sigma": 4}
    got = tm.result(output="device")
    monkeypatch.setattr(TemplateMatcher, "_local_inv", _former_local_inv)
    tm.reset()
    tm.match(ms)
    for a, b in zip(got, tm.result(output="device")):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# widths of the sigma kernel's designs: registers, shared memory (even
# and odd) and Bluestein's (X / 2 = 97, a prime above MAX_DIRECT)
WIDTHS = {"registers": 128, "shared": 36, "odd": 33, "bluestein": 194}


def _wide_data(orientations=16, width=128):
    rng = np.random.default_rng(7)
    shape = (24, 40, width)
    tomogram = (_blobs(rng, shape, 12, 2.5, 10.0)
                + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    template = _elongated(rng)
    ms = traffic.rotation_pool(rng, orientations, (BOX,) * 3)
    return tomogram, template, ms


@pytest.mark.cuda
@pytest.mark.parametrize("spherical,design", [
    (True, "registers")] + [(False, d) for d in WIDTHS])
def test_on_the_card_the_sigma_kernel_takes_each_orientation(card,
                                                             spherical,
                                                             design):
    tomogram, template, ms = _wide_data(width=WIDTHS[design])
    assert match_sigma.design(WIDTHS[design]) == (
        "shared" if design == "odd" else design)
    mask = _mask() if spherical else _ellipsoid()
    tm = TemplateMatcher(tomogram, template, mask, device="cuda")
    assert tm.spherical == spherical
    tm.match(ms[:1])                      # builds the kernels
    tm.reset()
    torch.cuda.synchronize()
    _build.reset_launches()
    moved, _ = _traced(tm, ms, ("match.local_sigma",))
    per = 0 if spherical else 16
    assert moved == {"match.local_sigma": per}
    launches = _build.launches()
    assert launches[match_sigma.NAME] == per
    assert launches[match_sigma.FINISH_NAME] == per
    # the same call with the tail's plain version, within the cells' limit
    # on max_rel_err (portbench/cells/tm512-nsmask-match.json)
    scores, indices = tm.result()
    kernel = match_sigma.match_sigma
    try:
        match_sigma.match_sigma = match_sigma.plain_match_sigma
        tm.reset()
        tm.match(ms)
    finally:
        match_sigma.match_sigma = kernel
    want, index = tm.result()
    assert np.abs(scores - want).max() <= 1e-4 * np.abs(want).max()
    assert (indices != index).mean() <= 0.01


@pytest.mark.cuda
def test_on_the_card_the_sigma_kernel_queues_without_a_sync(card):
    tomogram, template, ms = _wide_data(orientations=4)
    tm = TemplateMatcher(tomogram, template, _ellipsoid(), device="cuda")
    tm.match(ms[:1])                      # builds the kernels, plans FFTs
    tm.reset()
    torch.cuda.synchronize()
    before = _build.launches()[match_sigma.NAME]
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.match(ms)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.launches()[match_sigma.NAME] == before + 4


@pytest.mark.cuda
def test_on_the_card_a_width_past_the_sigma_kernel_is_refused(card):
    width = match_sigma.MAX_WIDTH + 1
    tomogram = np.random.default_rng(3).standard_normal(
        (BOX, BOX, width)).astype(np.float32)
    _, template, _, _ = _data(orientations=1)
    with pytest.raises(ValueError, match="sigma kernel takes a width"):
        TemplateMatcher(tomogram, template, _ellipsoid(), device="cuda")
    # a spherical mask never takes the sigma kernel
    tm = TemplateMatcher(tomogram, template, _mask(), device="cuda")
    assert tm.spherical


@pytest.mark.cuda
def test_on_the_card_the_non_spherical_path_queues_without_a_sync(card):
    tomogram, template, _, ms = _data()
    mask = _ellipsoid()
    tm = TemplateMatcher(tomogram, template, mask, device="cuda")
    assert not tm.spherical
    tm.match(ms[:1])                      # builds kernel A, plans the FFTs
    tm.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.match(ms)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    scores, indices = tm.result()
    best, index, second = (t.numpy() for t in _reference(
        tomogram, template, mask, ms))
    assert np.abs(scores - best).max() <= 1e-4 * np.abs(best).max()
    clear = (best - second) > 1e-3
    np.testing.assert_array_equal(indices[clear], index[clear])


@pytest.mark.cuda
def test_on_the_card_tm512_nsmask_agrees_within_the_cells_limits(card):
    from portbench import harness
    cell = harness.make_cell("tm512-nsmask-match", 2 ** 31 + 24, 0.5,
                             False, "cuda")
    driver = harness.load_module("drivers",
                                 cell.traffic["driver"]).Driver(cell)
    driver.setup()
    record = driver.window()
    driver.release()
    assert record["completed"] >= 16
    result = driver.check()
    compared = result["compared"]
    assert compared["max_rel_err"] <= cell.limits["max_rel_err"]
    assert compared["index_mismatch"] <= cell.limits["index_mismatch"]
    assert result["failed"] == 0

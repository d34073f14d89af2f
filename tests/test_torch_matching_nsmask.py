"""Template matching under a mask that is not spherical
(``voltools_tpu_torch.TemplateMatcher``'s path for pytom-match-pick's
``--non-spherical-mask``) against the benchmark's float64 reference
(``portbench/reference/matching_nsmask.py``), and that reference against
a direct sum and against the fixed-mask reference, at the small size of
``tests/test_torch_matching.py``: a (24, 40, 36) tomogram, a 12^3
template, here an ellipsoidal mask of semi-axes (5, 3.5, 2.5).

The card tests (marker ``cuda``, skipped without a CUDA device) import no
JAX; on the card's machine::

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
        "match.orientations", "match.transforms", "match.pruned_rows",
        "match.local_sigma"))
    assert moved == {"match.orientations": 3,
                     "match.transforms": 3 * (2 if spherical else 5),
                     "match.pruned_rows": 3 * BOX * BOX * (
                         1 if spherical else 2),
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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


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

"""Template matching with pytom-match-pick's random-phase correction
(``voltools_tpu_torch.TemplateMatcher(..., random_phase_correction=True)``)
against the benchmark's float64 reference
(``portbench/reference/matching_rpc.py``) at the small size of
``tests/test_torch_matching.py`` (a (24, 40, 36) tomogram, a 12^3
template), under a spherical mask and under an ellipsoidal one; the noise
template against a direct numpy definition; and the update kernel's
max-only entry (``kernels/match_update.py::match_noise_update``) against
its plain version.

The card tests (marker ``cuda``, skipped without a CUDA device) import no
JAX; on the card's machine::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_matching_rpc.py -q
"""

import math

import numpy as np
import pytest
import torch

from portbench.reference import matching_rpc as reference
from voltools_tpu_torch import TemplateMatcher
from voltools_tpu_torch.kernels import _build, match_update as mu
from voltools_tpu_torch.models.matching import phase_randomize_template
from voltools_tpu_torch.utils import trace

from test_torch_match_update import CASES, case
from test_torch_matching import BOX, _data
from test_torch_matching_nsmask import _ellipsoid

MASKS = ["spherical", "ellipsoidal"]


def _matcher(mask_kind, device="cpu", orientations=8, seed=20251018,
             **kw):
    tomogram, template, mask, ms = _data(seed, orientations)
    if mask_kind == "ellipsoidal":
        mask = _ellipsoid()
    tm = TemplateMatcher(tomogram, template, mask, device=device,
                         random_phase_correction=True, **kw)
    assert tm.spherical == (mask_kind == "spherical")
    return tm, (tomogram, template, mask, ms)


def _pytom_noise(template, seed):
    """pytom-match-pick's phase randomisation, as its source reads (with
    the axes that NumPy 2 asks for beside ``s``)."""
    ft = np.fft.rfftn(template)
    amplitude = np.abs(ft)
    phase = np.angle(ft).flatten()
    phase = np.random.default_rng(seed).permutation(phase)
    phase = phase.reshape(amplitude.shape)
    return np.fft.irfftn(amplitude * np.exp(1j * phase), s=template.shape,
                         axes=(0, 1, 2))


@pytest.mark.parametrize("mask_kind", MASKS)
def test_the_matcher_agrees_with_the_rpc_reference(mask_kind):
    tm, (tomogram, template, mask, ms) = _matcher(mask_kind)
    tm.match(ms)
    corrected, indices = tm.result()
    noise = tm.noise_result()
    best, index, second, want_noise, want_corrected = (
        t.numpy() for t in reference.match(
            torch.from_numpy(tomogram), torch.from_numpy(template),
            torch.from_numpy(mask), ms,
            rotate_mask=mask_kind == "ellipsoidal"))
    scale = np.abs(best).max()
    # float32 transforms against float64: 1e-4 of the largest score
    for got, want in ((tm.scores.numpy(), best), (noise, want_noise),
                      (corrected, want_corrected)):
        assert np.abs(got - want).max() <= 1e-4 * scale
    clear = (best - second) > 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(indices[clear], index[clear])
    # the correction moves the map: the noise template scores
    assert np.abs(noise).max() > 0.1 * scale
    assert corrected.dtype == noise.dtype == np.float32


@pytest.mark.parametrize("seed", [321, 7, 2 ** 40 + 3])
def test_the_noise_template_is_pytoms_with_the_templates_amplitudes(seed):
    _, template, _, _ = _data()
    noise = phase_randomize_template(template, seed)
    want = _pytom_noise(template.astype(np.float64), seed)
    np.testing.assert_array_equal(noise, want)
    assert noise.dtype == np.float64 and noise.shape == template.shape
    # off the planes that the inverse makes Hermitian (x' = 0 and the
    # Nyquist plane), every frequency keeps its amplitude and takes its
    # permuted phase
    ft, got = np.fft.rfftn(template.astype(np.float64)), np.fft.rfftn(noise)
    inner = np.s_[:, :, 1:template.shape[2] // 2]
    np.testing.assert_allclose(np.abs(got[inner]), np.abs(ft[inner]),
                               rtol=1e-9, atol=1e-9 * np.abs(ft).max())
    phase = np.random.default_rng(seed).permutation(
        np.angle(ft).ravel()).reshape(ft.shape)
    big = np.abs(ft[inner]) > 1e-6 * np.abs(ft).max()
    turn = np.angle(got[inner] * np.exp(-1j * phase[inner]))
    assert np.abs(turn[big]).max() < 1e-6
    # the reference's own lines make the same template
    ref = reference.phase_randomised(torch.from_numpy(template), seed)
    np.testing.assert_array_equal(ref.numpy(), noise)
    # and the matcher keeps it as float32 (linear: no prefilter)
    tm = TemplateMatcher(*_data()[:3], device="cpu",
                         interpolation="linear",
                         random_phase_correction=True, rng_seed=seed)
    assert torch.equal(tm._noise_sv.data.contiguous(), torch.from_numpy(
        noise.astype(np.float32)))


@pytest.mark.parametrize("mask_kind", MASKS)
def test_with_the_option_off_the_maps_are_the_templates_alone(mask_kind):
    tm, (tomogram, template, mask, ms) = _matcher(mask_kind)
    off = TemplateMatcher(tomogram, template, mask, device="cpu")
    assert off.noise is None and tm.noise is not None
    for m in (tm, off):
        m.match(ms)
    # the noise path leaves the template's maps bit for bit as they are
    # without it, and without it the result is those maps
    assert torch.equal(tm.scores, off.scores)
    assert torch.equal(tm.indices, off.indices)
    scores, indices = off.result(output="device")
    assert torch.equal(scores, off.scores) and torch.equal(indices,
                                                           off.indices)
    with pytest.raises(ValueError, match="random_phase_correction"):
        off.noise_result()


@pytest.mark.parametrize("mask_kind", MASKS)
def test_reset_and_chunked_calls_are_bit_for_bit_one_call(mask_kind):
    tm, (_, _, _, ms) = _matcher(mask_kind, orientations=7)
    tm.match(ms)
    whole = (*tm.result(output="device"), tm.noise_result("device"))
    tm.reset()
    assert tm.orientations == 0
    tm.match(ms[:3])
    tm.match(ms[3])
    tm.match(ms[4:])
    assert tm.orientations == 7
    got = (*tm.result(output="device"), tm.noise_result("device"))
    for a, b in zip(whole, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mask_kind", MASKS)
def test_no_orientation_scored_reads_minus_inf_and_no_nan(mask_kind):
    tm, (_, _, _, ms) = _matcher(mask_kind)
    for when in ("constructed", "reset"):
        if when == "reset":
            tm.match(ms[:2])
            tm.reset()
        scores, indices = tm.result()
        noise = tm.noise_result()
        assert not np.isnan(scores).any() and not np.isnan(noise).any()
        assert np.all(scores == -np.inf) and np.all(noise == -np.inf)
        assert np.all(indices == -1)
    tm.match(ms[:1])
    scores, _ = tm.result()
    assert np.isfinite(scores).all()


@pytest.mark.parametrize("mask_kind", MASKS)
def test_each_orientation_scores_the_noise_template_in_its_spans(mask_kind):
    tm, (_, _, _, ms) = _matcher(mask_kind, orientations=3)
    spherical = mask_kind == "spherical"
    names = ("match.orientations", "match.transforms",
             "match.zpass_products", "match.random_phase")
    before = trace.counts()
    trace.start()
    try:
        tm.match(ms)
    finally:
        trace.stop()
    after = trace.counts()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in names}
    assert moved == {"match.orientations": 3,
                     "match.transforms": 3 * (4 if spherical else 7),
                     "match.zpass_products": 3 * (2 if spherical else 4),
                     "match.random_phase": 3}
    spans = [e["name"] for e in trace.export()["traceEvents"]
             if e.get("ph") == "X"]
    order = [n for n in spans if n.startswith("match.")]
    per = ["match.template", "match.correlate"] + (
        [] if spherical else ["match.sigma"]) + [
        "match.update", "match.noise", "match.noise_update"]
    assert order == per * 3


def test_the_noise_update_refuses_what_the_update_refuses():
    cc, inv, noise, _, _ = case("reset_start")
    for bad in (inv.double(), inv[:-1], inv.transpose(0, 2)):
        with pytest.raises(ValueError):
            mu.match_noise_update(cc, bad, noise)


@pytest.mark.parametrize("update", ["plain", "wrapper"])
@pytest.mark.parametrize("name", CASES)
def test_the_noise_update_is_the_maximum_of_the_scaled_correlation(
        name, update):
    cc, inv, noise, _, _ = case(name)
    want = torch.maximum(noise, cc * inv)
    kept = cc.clone()
    launches = _build.launches()[mu.NOISE_NAME]
    fn = (mu.plain_match_noise_update if update == "plain"
          else mu.match_noise_update)
    fn(cc, inv, noise)
    assert torch.equal(noise.view(torch.int32), want.view(torch.int32))
    assert torch.equal(cc.view(torch.int32), kept.view(torch.int32))
    assert _build.launches()[mu.NOISE_NAME] == launches


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 7, 9), (1,), (3,), (4099,),
                                   (3, 4096 * 4 + 5), (256, 512, 512)])
@pytest.mark.parametrize("name", CASES)
def test_on_the_card_the_noise_entry_is_its_plain_version(dev, name, shape):
    cc, inv, noise, _, _ = (t.to(dev) if isinstance(t, torch.Tensor) else t
                            for t in case(name, shape))
    plain = noise.clone()
    mu.plain_match_noise_update(cc, inv, plain)
    launches = _build.launches()[mu.NOISE_NAME]
    before = mu.improved_voxels(dev)
    mu.match_noise_update(cc, inv, noise)
    torch.cuda.synchronize()
    assert torch.equal(noise.view(torch.int32), plain.view(torch.int32))
    assert _build.launches()[mu.NOISE_NAME] - launches == 1
    assert mu.improved_voxels(dev) == before     # it counts nothing


@pytest.mark.cuda
def test_on_the_card_a_misaligned_noise_map_is_refused(dev):
    cc, inv, noise, _, _ = case("reset_start", (64,))
    maps = [t.to(dev)[1:] for t in (cc, inv, noise)]
    with pytest.raises(ValueError, match="16-byte"):
        mu.match_noise_update(*maps)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", MASKS)
def test_on_the_card_match_queues_without_a_sync_and_agrees(dev,
                                                           mask_kind):
    tm, (tomogram, template, mask, ms) = _matcher(mask_kind, "cuda")
    tm.match(ms[:1])                      # builds the kernels
    tm.reset()
    torch.cuda.synchronize()
    launches = _build.launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.match(ms)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = _build.launches()
    assert after[mu.NOISE_NAME] - launches[mu.NOISE_NAME] == len(ms)
    assert after["match_update"] - launches["match_update"] == len(ms)
    assert after["match_zpass"] - launches["match_zpass"] == len(ms) * (
        2 if mask_kind == "spherical" else 3)
    corrected, indices = tm.result()
    best, index, second, noise, want = (t.numpy() for t in reference.match(
        torch.from_numpy(tomogram), torch.from_numpy(template),
        torch.from_numpy(mask), ms, rotate_mask=mask_kind == "ellipsoidal"))
    scale = np.abs(best).max()
    for got, ref in ((tm.scores.cpu().numpy(), best),
                     (tm.noise_result(), noise), (corrected, want)):
        assert np.abs(got - ref).max() <= 1e-4 * scale
    clear = (best - second) > 1e-3
    np.testing.assert_array_equal(indices[clear], index[clear])


@pytest.mark.cuda
def test_on_the_card_tm1024_rpc_agrees_within_the_cells_limits(dev):
    from portbench import harness
    cell = harness.make_cell("tm1024-rpc-match", 2 ** 31 + 27, 0.5, False,
                             "cuda")
    driver = harness.load_module("drivers",
                                 cell.traffic["driver"]).Driver(cell)
    driver.setup()
    record = driver.window()
    driver.release()
    assert record["completed"] >= 16
    result = driver.check()
    for key, value in result["compared"].items():
        assert value <= cell.limits[key], (key, value)
    assert result["failed"] == 0
    assert not math.isnan(result["compared"]["max_rel_err"])

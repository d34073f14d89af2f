"""The port's registration (``voltools_tpu_torch.models.registration``)
against the JAX package's (``voltools_tpu.models.registration``).

Same seeded inputs through both, on the CPU (the port's ``device='cpu'``,
JAX's XLA sampler):

* ``phase_cross_correlation``: equal to JAX's on the inputs of
  ``tests/test_registration.py`` (integer shifts exactly, the Fourier and
  resampled shifts at upsample 20 on the same grid point, atol 1e-6);
  ``_upsampled_region`` within 1e-5 (on a spectrum scaled to O(1) values);
  the validation errors with JAX's messages;
* the pyramid's ``_resize`` within 1e-6 of ``jax.image.resize(...,
  'linear')`` (antialiased) on extents of 32, 33, 25 and 9;
* the objective's value and gradient within rtol 1e-4 / atol 1e-6 of
  ``jax.value_and_grad`` for each model x loss, linear and filt_bspline;
  one Adam step within 1e-6;
* ``register`` on the scenarios of ``tests/test_registration.py``, each
  with the JAX test's own recovery bound and with theta within 2e-3 of
  JAX's ``register`` on the same inputs;
* d(loss)/dw by central differences through the port's sampler and
  ``rodrigues_matrix`` (the zero-shell cases of ``tests/test_autodiff.py``,
  its 3% bound).
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from scipy.ndimage import gaussian_filter

from voltools_tpu.models import registration as jreg
from voltools_tpu.ops.prefilter import bspline_prefilter as jax_prefilter
from voltools_tpu.ops.sampling import affine_sample as jax_sample
from voltools_tpu_torch.models import (RegistrationResult,
                                       phase_cross_correlation, register)
from voltools_tpu_torch.models import registration as treg
from voltools_tpu_torch.ops.prefilter import bspline_prefilter
from voltools_tpu_torch.ops.sampling import affine_sample
from voltools_tpu_torch.utils import rodrigues_matrix

THETA_ATOL = 2e-3      # port's register against JAX's, every parameter


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread per test process keeps parallel
    test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smooth(shape, seed=0, sigma=2.0):
    rng = np.random.default_rng(seed)
    v = gaussian_filter(rng.standard_normal(shape), sigma)
    return (v / np.abs(v).max()).astype(np.float32)


def _content_shift_matrix(t):
    """Pull-back matrix moving content by +t (src = x - t)."""
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = -np.asarray(t, np.float32)
    return m


def _shifted(ref, t, interpolation="linear"):
    """``ref``'s content moved by ``-t`` (the port's sampler), so that the
    registering content-shift is ``+t``."""
    return affine_sample(torch.from_numpy(ref), _content_shift_matrix(-t),
                         interpolation).numpy()


def _theta(res):
    return np.concatenate([np.ravel(res.params[k]) for k in sorted(
        res.params)])


def _register_both(mov, ref, **kw):
    """(port's result, JAX's result) of one registration; theta agrees."""
    got = register(mov, ref, device="cpu", **kw)
    want = jreg.register(mov, ref, **kw)
    assert isinstance(got, RegistrationResult) and got.model == want.model
    np.testing.assert_allclose(_theta(got), _theta(want), atol=THETA_ATOL)
    assert got.loss_history.shape == want.loss_history.shape
    return got, want


def _fourier_shifted(ref, t):
    F = np.fft.fftn(ref)
    k = [np.fft.fftfreq(n) for n in ref.shape]
    ph = np.exp(-2j * np.pi * (k[0][:, None, None] * t[0]
                               + k[1][None, :, None] * t[1]
                               + k[2][None, None, :] * t[2]))
    return np.fft.ifftn(F * ph).real.astype(np.float32)


# ---------------------------------------------------------------------------
# phase cross-correlation
# ---------------------------------------------------------------------------

def test_pcc_integer_shift_exact():
    ref = _smooth((24, 26, 22), seed=1)
    mov = np.roll(ref, (4, -3, 2), axis=(0, 1, 2))
    got = phase_cross_correlation(ref, mov, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_array_equal(got.numpy(), [-4.0, 3.0, -2.0])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jreg.phase_cross_correlation(ref, mov)))


@pytest.mark.parametrize("normalization,source,bound", [
    ("phase", "fourier", 0.06), (None, "fourier", 0.06),
    (None, "resampled", 0.15)])
def test_pcc_subvoxel_matches_jax(normalization, source, bound):
    """The refined peak lands on JAX's grid point (atol 1e-6) and within
    the JAX test's bound of the true shift."""
    sigma = 2.5 if source == "fourier" else 1.2
    ref = _smooth((32, 32, 32), seed=2, sigma=sigma)
    t = np.asarray([1.3, -0.6, 0.4], np.float32)
    mov = (_fourier_shifted(ref, t) if source == "fourier"
           else _shifted(ref, -t))
    got = phase_cross_correlation(ref, mov, upsample=20,
                                  normalization=normalization,
                                  device="cpu").numpy()
    want = np.asarray(jreg.phase_cross_correlation(
        ref, mov, upsample=20, normalization=normalization))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, -t, atol=bound)


def test_pcc_matches_translate_verb():
    from voltools_tpu_torch import transform

    ref = _smooth((20, 20, 20), seed=3)
    mov = np.roll(ref, (3, 0, -2), axis=(0, 1, 2))
    shift = phase_cross_correlation(ref, mov, device="cpu").numpy()
    back = transform(mov, translation=tuple(shift), device="cpu")
    c = 5
    np.testing.assert_allclose(back[c:-c, c:-c, c:-c],
                               ref[c:-c, c:-c, c:-c], atol=1e-4)


def test_upsampled_region_matches_jax():
    """The separable cos/sin contractions, within 1e-5: the spectrum is
    whitened and divided by the voxel count, so the surface is O(1)."""
    rng = np.random.default_rng(11)
    shape = (16, 18, 14)
    rre = rng.standard_normal(shape).astype(np.float32)
    rim = rng.standard_normal(shape).astype(np.float32)
    mag = np.sqrt(rre * rre + rim * rim) * np.float32(np.prod(shape))
    rre, rim = rre / mag, rim / mag
    coarse = np.asarray([2.0, -3.0, 0.0], np.float32)
    upsample, npoints = 10, 2 * 15 + 1
    got, offs = treg._upsampled_region(torch.from_numpy(rre),
                                       torch.from_numpy(rim),
                                       torch.from_numpy(coarse), upsample,
                                       npoints)
    want, joffs = jreg._upsampled_region(jnp.asarray(rre), jnp.asarray(rim),
                                         jnp.asarray(coarse), upsample,
                                         npoints)
    assert got.shape == (npoints,) * 3
    np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_pcc_validation():
    v = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(ValueError, match="equally-shaped 3D volumes"):
        phase_cross_correlation(v, np.zeros((8, 8, 9), np.float32),
                                device="cpu")
    with pytest.raises(ValueError, match="upsample must be >= 1"):
        phase_cross_correlation(v, v, upsample=0, device="cpu")
    with pytest.raises(ValueError, match="normalization must be 'phase'"):
        phase_cross_correlation(v, v, normalization="bogus", device="cpu")


def test_cuda_is_the_default_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    v = _smooth((8, 8, 8))
    with pytest.raises(ValueError, match="Unknown device"):
        phase_cross_correlation(v, v)
    with pytest.raises(ValueError, match="Unknown device"):
        register(v, v, model="translation", steps=1)


# ---------------------------------------------------------------------------
# the pyramid's resize, the objective, Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [32, 33, 25, 9])
def test_resize_matches_jax_antialiased(n):
    """Each pyramid level's shape, ``max(4, round(s / f))`` (half to even),
    from extents (n, n + 1, n - 1): odd extents give non-integer scales."""
    vol = np.random.default_rng(n).random((n, n + 1, n - 1)).astype(
        np.float32)
    for f in (2, 4):
        shape = tuple(max(4, round(s / f)) for s in vol.shape)
        got = treg._resize(torch.from_numpy(vol), shape).numpy()
        want = np.asarray(jax.image.resize(jnp.asarray(vol), shape,
                                           method="linear"))
        assert got.shape == shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6)
    # the antialiasing matters: trilinear interpolation without it differs
    shape = tuple(max(4, round(s / 2)) for s in vol.shape)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(vol)[None, None], size=shape, mode="trilinear",
        align_corners=False)[0, 0].numpy()
    assert np.abs(plain - treg._resize(torch.from_numpy(vol),
                                       shape).numpy()).max() > 1e-3


OBJ_SHAPE = (16, 16, 16)
OBJ_EDGE = 2


def _jax_objective(mov, ref, model, interpolation, loss):
    """The JAX level program's objective, from its own pieces."""
    center = tuple((s - 1) / 2.0 for s in mov.shape)
    pre = interpolation.startswith("filt_bspline")
    coef = (jax_prefilter(jnp.asarray(mov), boundary="mirror") if pre
            else jnp.asarray(mov))
    target = jreg._crop(jnp.asarray(ref), OBJ_EDGE)

    def objective(theta):
        m = jreg._theta_to_matrix(theta, model, center)
        out = jax_sample(coef, m, interpolation, prefiltered=pre)
        return jreg._loss_fn(jreg._crop(out, OBJ_EDGE), target, loss)
    return objective


@pytest.mark.parametrize("interpolation", ["linear", "filt_bspline"])
@pytest.mark.parametrize("loss", ["mse", "ncc"])
@pytest.mark.parametrize("model", ["translation", "rigid", "affine"])
def test_objective_value_and_grad_match_jax(model, loss, interpolation):
    mov, ref = _smooth(OBJ_SHAPE, seed=3), _smooth(OBJ_SHAPE, seed=4)
    rng = np.random.default_rng(5)
    theta = rng.uniform(-0.1, 0.1, treg._theta_size(model)).astype(
        np.float32)
    want_l, want_g = jax.value_and_grad(
        _jax_objective(mov, ref, model, interpolation, loss))(
            jnp.asarray(theta))
    coef = torch.from_numpy(mov)
    if interpolation == "filt_bspline":
        coef = bspline_prefilter(coef, boundary="mirror")
    th = torch.from_numpy(theta).requires_grad_(True)
    got_l = treg._objective(th, coef,
                            treg._crop(torch.from_numpy(ref), OBJ_EDGE),
                            treg._center(OBJ_SHAPE, coef.device), model,
                            interpolation, OBJ_EDGE, loss)
    (got_g,) = torch.autograd.grad(got_l, th)
    np.testing.assert_allclose(got_l.item(), float(want_l), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("model,loss,interpolation", [
    ("translation", "mse", "linear"), ("rigid", "ncc", "linear"),
    ("affine", "ncc", "filt_bspline")])
def test_one_adam_step_matches_jax(model, loss, interpolation):
    """One step of the hand-written Adam (bias corrections, cosine rate)
    from a non-zero theta: theta and the loss within 1e-6."""
    mov, ref = _smooth(OBJ_SHAPE, seed=6), _smooth(OBJ_SHAPE, seed=7)
    theta = np.random.default_rng(8).uniform(
        -0.1, 0.1, treg._theta_size(model)).astype(np.float32)
    run = jreg._level_program(OBJ_SHAPE, model, interpolation, loss, 1,
                              0.02, OBJ_EDGE)
    want_t, want_h = run(jnp.asarray(mov), jnp.asarray(ref),
                         jnp.asarray(theta))
    got_t, got_h = treg._adam_level(
        torch.from_numpy(mov), torch.from_numpy(ref),
        torch.from_numpy(theta), model, interpolation, loss, 1, 0.02,
        OBJ_EDGE)
    assert not got_t.requires_grad
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-6)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-6)
    # the schedule's constants, as the JAX program forms them in float32
    bc1, bc2, lr_i = treg._adam_schedule(5, 0.02, torch.device("cpu"))
    t = jnp.arange(5, dtype=jnp.float32) + 1.0
    np.testing.assert_array_equal(bc1.numpy(), np.asarray(1 - 0.9 ** t))
    np.testing.assert_array_equal(bc2.numpy(), np.asarray(1 - 0.999 ** t))
    i = jnp.arange(5, dtype=jnp.float32)
    np.testing.assert_allclose(
        lr_i.numpy(), np.asarray(0.02 * 0.5 * (1.0 + jnp.cos(jnp.pi * i / 5))),
        rtol=1e-6)


@pytest.mark.parametrize("model", ["rigid", "affine"])
def test_adam_steps_make_no_tensor_from_host_data(model, monkeypatch):
    """A tensor made from host data inside a step would be a copy that,
    on a CUDA device, waits for the device's queue: two more steps make
    no more such tensors (the centre is made once a level)."""
    made = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counting(data, *args, _real=real, **kw):
            if not isinstance(data, torch.Tensor):
                made.append(data)
            return _real(data, *args, **kw)
        monkeypatch.setattr(torch, name, counting)
    vol = torch.from_numpy(_smooth(OBJ_SHAPE, seed=9))
    theta = torch.zeros(treg._theta_size(model))
    counts = []
    for steps in (2, 4):
        made.clear()
        treg._adam_level(vol, vol, theta, model, "linear", "ncc", steps,
                         0.02, OBJ_EDGE)
        counts.append(len(made))
    assert counts[0] == counts[1], counts


# ---------------------------------------------------------------------------
# register: the scenarios of tests/test_registration.py
# ---------------------------------------------------------------------------

def test_register_translation_model():
    ref = _smooth((24, 24, 24), seed=4)
    t = np.asarray([0.8, -0.5, 0.3], np.float32)
    mov = _shifted(ref, t)
    res, _ = _register_both(mov, ref, model="translation", steps=100,
                            lr=0.05, loss="mse")
    np.testing.assert_allclose(res.params["t"], t, atol=0.05)
    assert res.loss_history[-1] < res.loss_history[0]


def test_register_rigid_recovers_rotation_and_shift():
    ref = _smooth((24, 24, 24), seed=5, sigma=1.8)
    center = tuple((s - 1) / 2 for s in ref.shape)
    w_true = np.asarray([0.06, -0.09, 0.07], np.float32)
    t_true = np.asarray([0.6, -0.4, 0.3], np.float32)
    m_true = rodrigues_matrix(torch.from_numpy(w_true), center).numpy()
    m_true[:3, 3] -= t_true
    target = affine_sample(torch.from_numpy(ref), m_true, "linear").numpy()
    res, _ = _register_both(ref, target, model="rigid", steps=100, lr=0.03)
    err_deg = np.degrees(np.linalg.norm(res.params["w"] - w_true))
    assert err_deg < 0.3, f"rotation off by {err_deg:.3f} deg"
    out = affine_sample(torch.from_numpy(ref), res.matrix, "linear").numpy()
    c = 4
    err = np.abs(out - target)[c:-c, c:-c, c:-c].max()
    assert err < 0.02, f"registered volume off by {err:.4f}"


def test_register_ncc_intensity_invariant():
    ref = _smooth((20, 20, 20), seed=6)
    t = np.asarray([0.7, 0.2, -0.4], np.float32)
    mov = _shifted(ref, t)
    res, _ = _register_both(mov, 3.0 * ref + 1.0, model="translation",
                            loss="ncc", steps=100, lr=0.05,
                            init_translation=None)
    np.testing.assert_allclose(res.params["t"], t, atol=0.08)


def test_register_affine_recovers_scale():
    ref = _smooth((24, 24, 24), seed=7, sigma=2.2)
    center = np.asarray([(s - 1) / 2 for s in ref.shape], np.float32)
    L = np.diag([1.06, 0.95, 1.03]).astype(np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = L
    m[:3, 3] = center - L @ center
    target = affine_sample(torch.from_numpy(ref), m, "linear").numpy()
    res, _ = _register_both(ref, target, model="affine", steps=100, lr=0.03,
                            init_translation=None)
    np.testing.assert_allclose(res.params["linear"], L, atol=0.02)


def test_register_multiscale_large_shift():
    """levels=2 pulls in a shift outside the single-level basin; the
    coarse level runs on the antialiased resize."""
    ref = _smooth((32, 32, 32), seed=8, sigma=2.5)
    t = np.asarray([4.0, -3.0, 2.5], np.float32)
    mov = _shifted(ref, t)
    res, want = _register_both(mov, ref, model="translation", steps=100,
                               lr=0.1, levels=2, init_translation=None)
    np.testing.assert_allclose(res.params["t"], t, atol=0.15)
    assert len(res.loss_history) == 200
    # the coarse level's losses are JAX's too (its resize feeds them)
    np.testing.assert_allclose(res.loss_history[:5], want.loss_history[:5],
                               rtol=1e-4)


def test_register_apply_roundtrip():
    ref = _smooth((20, 20, 20), seed=9)
    t = np.asarray([0.5, -0.3, 0.2], np.float32)
    mov = _shifted(ref, t)
    res, _ = _register_both(mov, ref, model="translation", steps=100,
                            lr=0.05)
    out = res.apply(mov, device="cpu")
    expected = _shifted(mov, -t)
    c = 3
    np.testing.assert_allclose(out[c:-c, c:-c, c:-c],
                               expected[c:-c, c:-c, c:-c], atol=0.02)
    # tensors are accepted as inputs, with the same outcome
    again = register(torch.from_numpy(mov), torch.from_numpy(ref),
                     model="translation", steps=100, lr=0.05, device="cpu")
    np.testing.assert_array_equal(again.matrix, res.matrix)


def test_register_validation():
    v = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(ValueError, match="model must be one of"):
        register(v, v, model="projective", device="cpu")
    with pytest.raises(ValueError, match="loss must be one of"):
        register(v, v, loss="ssim", device="cpu")
    with pytest.raises(ValueError, match="levels must be >= 1"):
        register(v, v, levels=0, device="cpu")
    with pytest.raises(ValueError, match="equally-shaped 3D volumes"):
        register(v, np.zeros((8, 8, 9), np.float32), device="cpu")
    with pytest.raises(ValueError, match="edge"):
        register(v, v, model="translation", edge=4, device="cpu")


def test_register_coarse_level_edge_clamped():
    """edge=5 is valid at full resolution (2*5 < 12); level 2's shape
    (8, 4, 4) needs the clamp.  ``v`` onto itself, as the JAX test runs
    it, starts Adam at the exact optimum, where its unit-sized first step
    follows the sign of rounding noise: there the history is only finite.
    A shifted copy gives the steps a gradient to follow, and theta and the
    history agree with JAX's."""
    v = _smooth((32, 12, 12), seed=5)
    res = register(v, v, model="translation", edge=5, levels=3, steps=2,
                   init_translation=None, device="cpu")
    assert res.loss_history.shape == (6,)
    assert np.isfinite(res.loss_history).all()
    mov = _shifted(v, np.asarray([0.6, -0.4, 0.3], np.float32))
    res, want = _register_both(mov, v, model="translation", edge=5,
                               levels=3, steps=2, init_translation=None)
    assert np.isfinite(res.loss_history).all()
    np.testing.assert_allclose(res.loss_history, want.loss_history,
                               rtol=1e-4, atol=1e-6)


def test_register_filt_bspline_prefilters_once(monkeypatch):
    """The level loop converts ``moving`` to coefficients once per level,
    never inside an Adam step, and converges as JAX's does."""
    ref = _smooth((20, 20, 20), seed=8)
    t = np.asarray([0.7, -0.4, 0.2], np.float32)
    mov = _shifted(ref, t, "filt_bspline")
    calls = []
    real = treg.bspline_prefilter

    def counting(vol, *args, **kw):
        calls.append(tuple(vol.shape))
        return real(vol, *args, **kw)

    monkeypatch.setattr(treg, "bspline_prefilter", counting)
    res, _ = _register_both(mov, ref, model="translation", steps=100,
                            lr=0.05, interpolation="filt_bspline",
                            loss="mse")
    assert calls == [(20, 20, 20)]
    np.testing.assert_allclose(res.params["t"], t, atol=0.06)
    assert res.loss_history[-1] < res.loss_history[0]
    calls.clear()
    register(mov, ref, model="translation", steps=3, levels=2,
             interpolation="filt_bspline", device="cpu")
    assert calls == [(10, 10, 10), (20, 20, 20)]


# ---------------------------------------------------------------------------
# the gradient through the port's sampler, by finite differences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interp,mode", [
    ("linear", "constant"), ("filt_bspline", "border"),
    ("bspline", "constant"), ("filt_bspline_simple", "constant"),
])
def test_grad_finite_difference_zero_shell(interp, mode):
    """d(loss)/dw by autograd against central differences, within 3%; the
    3-voxel zero shell keeps the constant-mode mask from making the loss
    jump where content crosses the boundary."""
    rng = np.random.default_rng(17)
    shape = (12, 13, 11)
    vol = np.zeros(shape, np.float32)
    vol[3:-3, 3:-3, 3:-3] = rng.random(tuple(s - 6 for s in shape),
                                       ).astype(np.float32)
    vol = torch.from_numpy(vol)
    w0 = torch.from_numpy(rng.uniform(-0.1, 0.1, 3).astype(np.float32))
    center = tuple((s - 1) / 2 for s in shape)

    def loss(w):
        m = rodrigues_matrix(w, center)
        return torch.sum(affine_sample(vol, m, interp, mode) ** 2)

    w = w0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(w), w)
    eps = 1e-3
    for i in range(3):
        e = torch.zeros(3)
        e[i] = eps
        fd = (loss(w0 + e).item() - loss(w0 - e).item()) / (2 * eps)
        gi = g[i].item()
        assert abs(fd - gi) <= 0.03 * max(1.0, abs(fd), abs(gi)), \
            (interp, mode, i, gi, fd)

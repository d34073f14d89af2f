"""Volume registration: the port's counterpart of
``voltools_tpu/models/registration.py``.

Recovering an unknown transform between two volumes -- the subtomogram
alignment cryo-ET users run around this library:

* :func:`phase_cross_correlation` -- the global translation from the
  cross-power spectrum (``torch.fft``), refined to a subvoxel grid by the
  matrix-multiply upsampled DFT of Guizar-Sicairos, Thurman & Fienup (Opt.
  Lett. 33, 156 (2008)): separable cos/sin contractions in full float32.

* :func:`register` -- gradient descent (translation / rigid / affine) by a
  hand-written Adam with cosine decay through the plain torch sampler
  (``ops/sampling.py``) and autograd, on a coarse-to-fine pyramid whose
  downsampling is the antialiased linear resize of ``jax.image.resize``.
  The JAX package differentiates through its XLA gather sampler in the same
  place (it has no kernel there either); the recovered transform is applied
  by :meth:`RegistrationResult.apply`, through the CUDA kernels.

Both run on the volumes' device: ``device='cuda'`` (the default) or
``'cpu'`` when asked for.  The Adam loop keeps its state and its loss
history on the device and makes no host round trip inside a level.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.interpolation import needs_prefilter
from ..ops.prefilter import bspline_prefilter
from ..ops.sampling import affine_sample
from ..transforms import _as_tensor, _device
from ..utils import full_fp32_matmul, rodrigues_matrix

__all__ = ["phase_cross_correlation", "register", "RegistrationResult",
           "AVAILABLE_MODELS", "AVAILABLE_LOSSES"]

AVAILABLE_MODELS = ["translation", "rigid", "affine"]
AVAILABLE_LOSSES = ["mse", "ncc"]

# Adam's constants, as the JAX package's level program
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


# ---------------------------------------------------------------------------
# phase cross-correlation
# ---------------------------------------------------------------------------

def _fftfreq(n: int, device) -> torch.Tensor:
    """``jnp.fft.fftfreq(n)`` in float32: ``k / n`` by a division, as JAX
    computes it (``torch.fft.fftfreq`` multiplies by ``1 / n``)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    k = (i + n // 2) % n - n // 2
    return k / torch.tensor(float(n), dtype=torch.float32, device=device)


def _upsampled_region(Rre, Rim, coarse, upsample: int, npoints: int):
    """The correlation surface on an ``npoints``^3 grid of spacing
    ``1 / upsample`` centred on the coarse peak ``coarse``.

    corr(d) = Re sum_k R[k] exp(+2 pi i sum_ax freq_ax[k_ax] d_ax) is
    separable, so each axis is a pair of small (npoints, N_ax) cos/sin
    contractions in real float32, run in full float32 (TF32 would move the
    refined peak)."""
    dev = Rre.device
    offs = (torch.arange(npoints, dtype=torch.float32, device=dev)
            - (npoints - 1) / 2.0) / float(upsample)
    re, im = Rre, Rim
    with full_fp32_matmul():
        for ax, n in enumerate(Rre.shape):
            d = coarse[ax] + offs                                  # (P,)
            ang = (2.0 * math.pi) * torch.outer(d, _fftfreq(n, dev))
            c, s = torch.cos(ang), torch.sin(ang)
            # contract the current axis 0 and move the new axis to the
            # back: after 3 rounds the original axis order is restored
            cre = torch.tensordot(c, re, dims=([1], [0]))
            cim = torch.tensordot(c, im, dims=([1], [0]))
            sre = torch.tensordot(s, re, dims=([1], [0]))
            sim = torch.tensordot(s, im, dims=([1], [0]))
            re = torch.movedim(cre - sim, 0, -1)
            im = torch.movedim(cim + sre, 0, -1)
    return re, offs


def phase_cross_correlation(reference, moving, *, upsample: int = 1,
                            normalization: str = "phase",
                            device: str = "cuda"):
    """Estimate the translation that registers ``moving`` onto ``reference``.

    Returns a float32 ``(3,)`` tensor on the call's device: the shift ``t``
    such that moving the *content* of ``moving`` by ``+t`` voxels best
    matches ``reference`` (``np.roll(moving, round(t))`` for integer
    shifts, ``transform(moving, translation=t)`` with this library).

    Parameters
    ----------
    upsample : int
        Subvoxel refinement factor (1 = integer-voxel estimate), a local
        matrix-multiply DFT on ``2 * ceil(1.5 * upsample) + 1`` points per
        axis.
    normalization : 'phase' | None
        'phase' whitens the cross-power spectrum (robust to intensity
        scaling; exact for a true Fourier shift); None keeps plain
        cross-correlation weighting, more accurate where ``moving`` was
        produced by interpolated resampling.
    device : 'cuda' (default), 'cuda:N' or 'cpu'.
    """
    if normalization not in ("phase", None):
        raise ValueError("normalization must be 'phase' or None, got "
                         f"{normalization!r}")
    upsample = int(upsample)
    if upsample < 1:
        raise ValueError(f"upsample must be >= 1, got {upsample}")
    dev = _device(device)
    a = _as_tensor(reference, dev)
    b = _as_tensor(moving, dev)
    if a.shape != b.shape or a.ndim != 3:
        raise ValueError("phase_cross_correlation needs two equally-shaped "
                         f"3D volumes, got {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")

    A = torch.fft.fftn(a)
    B = torch.fft.fftn(b)
    # R = A conj(B) in real arithmetic, as the JAX package forms it
    rre = A.real * B.real + A.imag * B.imag
    rim = A.imag * B.real - A.real * B.imag
    if normalization == "phase":
        mag = torch.clamp(torch.sqrt(rre * rre + rim * rim), min=1e-12)
        rre, rim = rre / mag, rim / mag

    corr = torch.fft.ifftn(torch.complex(rre, rim)).real
    shape = torch.tensor(corr.shape, device=dev)
    # the first maximum, as argmax gives it
    idx = torch.stack(torch.unravel_index(torch.argmax(corr), corr.shape))
    # wrap to signed displacements: a peak at d* means moving is reference
    # content-shifted by -d*, so +d* registers it
    coarse = torch.where(idx > shape // 2, idx - shape, idx).to(torch.float32)
    if upsample == 1:
        return coarse

    npoints = 2 * int(math.ceil(1.5 * upsample)) + 1
    region, offs = _upsampled_region(rre, rim, coarse, upsample, npoints)
    fine = torch.stack(torch.unravel_index(torch.argmax(region),
                                           region.shape))
    return coarse + offs[fine]


# ---------------------------------------------------------------------------
# gradient-descent registration
# ---------------------------------------------------------------------------

class RegistrationResult(NamedTuple):
    """Outcome of :func:`register`.

    ``matrix`` is the 4x4 pull-back matrix (scipy/reference convention):
    ``affine(moving, matrix)`` reproduces the registered volume.
    ``params`` holds the model's raw parameters (``w`` axis-angle radians,
    ``t`` content-shift voxels, ``linear`` 3x3 for the affine model).
    ``loss_history`` has one entry per optimisation step across all pyramid
    levels.
    """
    matrix: np.ndarray
    params: dict
    loss_history: np.ndarray
    model: str

    def apply(self, volume, **kwargs):
        """Resample ``volume`` through the recovered transform with
        :func:`~voltools_tpu_torch.affine` (kwargs as there; on a CUDA
        device the planner's kernel runs it)."""
        from ..transforms import affine
        return affine(volume, self.matrix, **kwargs)


def _theta_size(model: str) -> int:
    return {"translation": 3, "rigid": 6, "affine": 12}[model]


def _theta_to_matrix(theta, model: str, center):
    """Pull-back 4x4 from the flat parameter vector (differentiable).
    ``center`` is a float32 tensor on theta's device or a 3-tuple."""
    m = torch.eye(4, dtype=torch.float32, device=theta.device)
    if model == "translation":
        m[:3, 3] = -theta
        return m
    if model == "rigid":
        w, t = theta[:3], theta[3:]
        m[:3, 3] = -t
        return rodrigues_matrix(w, center=center) @ m
    # affine: src = (I + dL) @ (x - c) + c - t
    dL, t = theta[:9].reshape(3, 3), theta[9:]
    L = torch.eye(3, dtype=torch.float32, device=theta.device) + dL
    c = torch.as_tensor(center, dtype=torch.float32, device=theta.device)
    m[:3, :3] = L
    m[:3, 3] = c - L @ c - t
    return m


def _crop(x, edge: int):
    return x[edge:x.shape[0] - edge, edge:x.shape[1] - edge,
             edge:x.shape[2] - edge] if edge else x


def _loss_fn(out, target, loss: str):
    if loss == "mse":
        d = out - target
        return torch.mean(d * d)
    xm = out - torch.mean(out)
    ym = target - torch.mean(target)
    denom = torch.sqrt(torch.mean(xm * xm) * torch.mean(ym * ym) + 1e-12)
    return 1.0 - torch.mean(xm * ym) / denom


def _center(shape, device) -> torch.Tensor:
    """The volume's centre ``(s - 1) / 2`` as a float32 tensor on
    ``device``, made once a level: a tensor from host data in every step
    would be a copy that waits for the device (a host sync)."""
    return torch.tensor([(s - 1) / 2.0 for s in shape], dtype=torch.float32,
                        device=device)


def _objective(theta, moving, target, center, model: str,
               interpolation: str, edge: int, loss: str):
    """The level's loss at ``theta``: ``moving`` (B-spline coefficients
    where the interpolation needs them) resampled through the model's
    matrix about ``center`` (:func:`_center`), cropped by ``edge``, against
    the cropped ``target``."""
    m = _theta_to_matrix(theta, model, center)
    out = affine_sample(moving, m, interpolation,
                        prefiltered=needs_prefilter(interpolation))
    return _loss_fn(_crop(out, edge), target, loss)


def _adam_schedule(steps: int, lr: float, device):
    """Per-step float32 constants of the JAX package's Adam: the bias
    corrections ``1 - b ** t`` with ``t = i + 1`` and the cosine-decayed
    rate ``lr * 0.5 * (1 + cos(pi * i / steps))``."""
    i = torch.arange(steps, dtype=torch.float32, device=device)
    t = i + 1.0
    one = torch.ones((), dtype=torch.float32, device=device)
    bc1 = 1 - torch.pow(_B1 * one, t)
    bc2 = 1 - torch.pow(_B2 * one, t)
    lr_i = lr * 0.5 * (1.0 + torch.cos(math.pi * i / steps))
    return bc1, bc2, lr_i


def _adam_level(moving, reference, theta0, model: str, interpolation: str,
                loss: str, steps: int, lr: float, edge: int):
    """``steps`` Adam steps on one pyramid level; returns (theta, the loss
    of every step), both on the device.  ``moving`` is prefiltered once
    here when the interpolation needs it, never inside a step; the
    gradient is taken with respect to theta only."""
    if needs_prefilter(interpolation):
        moving = bspline_prefilter(moving, boundary="mirror")
    target = _crop(reference, edge)
    center = _center(moving.shape, moving.device)
    bc1, bc2, lr_i = _adam_schedule(steps, lr, theta0.device)
    theta = theta0.detach().clone()
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    history = torch.empty(steps, dtype=torch.float32, device=theta.device)
    with full_fp32_matmul():
        for i in range(steps):
            th = theta.detach().requires_grad_(True)
            value = _objective(th, moving, target, center, model,
                               interpolation, edge, loss)
            (g,) = torch.autograd.grad(value, th)
            history[i] = value.detach()
            m = _B1 * m + (1 - _B1) * g
            v = _B2 * v + (1 - _B2) * g * g
            mhat = m / bc1[i]
            vhat = v / bc2[i]
            # cosine decay: Adam's unit-sized steps otherwise orbit the
            # optimum at ~lr distance; decaying to 0 converges tightly
            theta = theta - lr_i[i] * mhat / (torch.sqrt(vhat) + _EPS)
    return theta, history


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """The (n_in, n_out) weights of ``jax.image.resize(method='linear')``
    along one axis (``compute_weight_mat`` with the triangle kernel and
    antialiasing): when downsampling the kernel is widened by ``1 /
    scale``, the weights of each output sample are normalised to sum 1,
    and samples outside ``[-0.5, n_in - 0.5]`` are zero."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=torch.float32,
                                device=device)
    inv = torch.tensor(inv_scale, dtype=torch.float32, device=device)
    sample_f = ((torch.arange(n_out, dtype=torch.float32, device=device)
                 + 0.5) * inv - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = torch.abs(sample_f[None, :] - src[:, None]) / kernel_scale
    weights = torch.clamp(1 - torch.abs(x), min=0)
    total = torch.sum(weights, dim=0, keepdim=True)
    eps32 = float(np.finfo(np.float32).eps)
    weights = torch.where(
        torch.abs(total) > 1000.0 * eps32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize(vol: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(vol, shape, method='linear')``: antialiased
    separable linear resampling, one full-float32 contraction per axis
    whose extent changes."""
    with full_fp32_matmul():
        for axis, (n_in, n_out) in enumerate(zip(vol.shape, shape)):
            if n_in == n_out:
                continue
            w = _resize_weights(n_in, n_out, vol.device)
            vol = torch.movedim(
                torch.tensordot(vol, w, dims=([axis], [0])), -1, axis)
    return vol.contiguous()


def register(moving, reference, *, model: str = "rigid",
             interpolation: str = "linear", loss: str = "ncc",
             steps: int = 200, lr: float = 0.02, levels: int = 1,
             edge: int = None, init_translation="phase",
             init_rotation=None, upsample: int = 10,
             device: str = "cuda") -> RegistrationResult:
    """Recover the transform aligning ``moving`` onto ``reference``.

    Minimises ``loss`` (``'ncc'`` -- intensity-invariant normalised
    cross-correlation -- or ``'mse'``) over the parameters of ``model``
    (``'translation'`` / ``'rigid'`` / ``'affine'``) by Adam through the
    differentiable torch sampler, on the volumes' device.

    Parameters
    ----------
    moving, reference : numpy arrays or tensors of one 3-D shape.
    steps, lr : per-level Adam step count / learning rate.  Rotation lives
        in radians and translation in voxels; Adam's per-parameter scaling
        absorbs the unit difference.
    levels : multi-resolution pyramid depth (level ``k`` runs at 1/2^k
        scale, coarse to fine; translations are rescaled between levels).
    edge : voxels cropped from every face before the loss.  Default: 5% of
        the smallest dimension (min 1).
    init_translation : ``'phase'`` (default -- seed from
        :func:`phase_cross_correlation` with ``upsample``), ``None``/zeros,
        or an explicit 3-vector.
    init_rotation : optional axis-angle (radians) seed for rigid/affine.
    device : 'cuda' (default), 'cuda:N' or 'cpu'.

    Returns :class:`RegistrationResult` (pull-back ``matrix`` + ``params``
    + per-step ``loss_history``, as numpy arrays).
    """
    if model not in AVAILABLE_MODELS:
        raise ValueError(f"model must be one of {AVAILABLE_MODELS}, "
                         f"got {model!r}")
    if loss not in AVAILABLE_LOSSES:
        raise ValueError(f"loss must be one of {AVAILABLE_LOSSES}, "
                         f"got {loss!r}")
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")

    dev = _device(device)
    mov = _as_tensor(moving, dev)
    ref = _as_tensor(reference, dev)
    if mov.shape != ref.shape or mov.ndim != 3:
        raise ValueError("register needs two equally-shaped 3D volumes, "
                         f"got {tuple(mov.shape)} vs {tuple(ref.shape)}")
    shape = tuple(mov.shape)
    if edge is None:
        edge = max(1, round(0.05 * min(shape)))
    if 2 * edge >= min(shape):
        # an empty crop makes the loss a mean over zero voxels: NaN history
        # and garbage parameters with no signal
        raise ValueError(f"edge={edge} leaves no voxels to compare: need "
                         f"2*edge < min(shape)={min(shape)}")

    # --- initial parameters -------------------------------------------------
    theta = np.zeros(_theta_size(model), np.float32)
    if isinstance(init_translation, str) and init_translation == "phase":
        t0 = phase_cross_correlation(ref, mov, upsample=upsample,
                                     device=device).cpu().numpy()
    elif init_translation is None:
        t0 = np.zeros(3, np.float32)
    else:
        t0 = np.asarray(init_translation, np.float32)
    if model == "translation":
        theta[:] = t0
    else:
        theta[-3:] = t0
        if init_rotation is not None:
            w0 = np.asarray(init_rotation, np.float32)
            if model == "rigid":
                theta[:3] = w0
            else:
                R0 = rodrigues_matrix(torch.from_numpy(w0))[:3, :3].numpy()
                theta[:9] = (R0 - np.eye(3, dtype=np.float32)).ravel()

    # --- coarse-to-fine -----------------------------------------------------
    histories = []
    theta = torch.from_numpy(theta).to(dev)
    for level in range(levels - 1, -1, -1):
        f = 2 ** level
        lshape = tuple(max(4, round(s / f)) for s in shape)
        scale = torch.tensor([ls / s for ls, s in zip(lshape, shape)],
                             dtype=torch.float32, device=dev)
        if lshape != shape:
            lmov, lref = _resize(mov, lshape), _resize(ref, lshape)
            # clamp so coarse-level rounding can never empty the crop even
            # when the full-resolution edge was valid
            ledge = min(max(1, round(edge * lshape[0] / shape[0])),
                        (min(lshape) - 1) // 2)
        else:
            lmov, lref, ledge = mov, ref, edge
        # translations live in voxels of the current level
        theta = torch.cat([theta[:-3], theta[-3:] * scale])
        theta, hist = _adam_level(lmov, lref, theta, model, interpolation,
                                  loss, int(steps), float(lr), int(ledge))
        theta = torch.cat([theta[:-3], theta[-3:] / scale])
        histories.append(hist.cpu().numpy())

    center = tuple((s - 1) / 2.0 for s in shape)
    with full_fp32_matmul():
        matrix = _theta_to_matrix(theta, model, center)
    theta_np = theta.cpu().numpy()
    matrix = matrix.cpu().numpy().astype(np.float32)
    if model == "translation":
        params = {"t": theta_np}
    elif model == "rigid":
        params = {"w": theta_np[:3], "t": theta_np[3:]}
    else:
        params = {"linear": np.eye(3, dtype=np.float32)
                  + theta_np[:9].reshape(3, 3), "t": theta_np[9:]}
    return RegistrationResult(matrix=matrix, params=params,
                              loss_history=np.concatenate(histories),
                              model=model)

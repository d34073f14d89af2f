"""Reference template matching: pytom-match-pick's score
(``pytom_tm/matching.py``; Chaillet et al., Int. J. Mol. Sci. 24:13375,
2023), Roseman's fast local correlation function (Ultramicroscopy 94:225,
2003), in float64, one orientation at a time.

For each 4x4 pull-back matrix about the template's centre ``c = n // 2``:
the template rotated by :mod:`portbench.reference.resample`'s prefiltered
cubic resample ('constant', ``cval``); its missing wedge applied on the
``rfftn`` grid; normalised to mean 0 and standard deviation 1 under the
mask ``M`` (``n = sum(M)``) and multiplied by ``M``; placed in a
tomogram-sized zero volume with its centre at the origin; correlated with
the tomogram, ``irfftn(conj(rfftn(placed)) * rfftn(V))``; divided by ``n
sigma``, ``sigma`` the tomogram's standard deviation under ``M`` about
each voxel (``(V^2 * M) / n - ((V * M) / n)^2``, each a correlation by FFT),
0 where ``sigma`` is at most ``1e-6`` of its largest.  A voxel keeps the
best score, the index of its orientation (the first, on a tie) and the
second-best score.

The wedge keeps a frequency where its angle from the third axis toward
the projection axis, ``atan2(k_p, k_q)`` taken onto (-90, 90], lies in the
tilt range, within 1e-9 degrees; the zero frequency is kept.

It imports nothing of ``voltools_tpu_torch`` or of the JAX package, batches
nothing and keeps nothing between calls.  ``dtype`` selects the control:
the rotation computed in ``dtype`` and every stored result after it
rounded to ``dtype``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import resample, rounder

SIGMA_FLOOR = 1e-6


def _rounder(dtype):
    """:func:`portbench.reference.rounder` of real and imaginary parts."""
    real = rounder(dtype)
    if dtype == torch.float64:
        return real
    return lambda t: (torch.complex(real(t.real), real(t.imag))
                      if t.is_complex() else real(t))


def wedge(box, tilt_range, tilt_axis: int, projection_axis: int,
          device=None) -> torch.Tensor:
    """The binary wedge (float64) on the ``rfftn`` grid of ``box``."""
    q = 3 - tilt_axis - projection_axis
    # the last axis's frequencies as rfftn holds them (+0.5 at an even
    # size's Nyquist, which stands for -0.5 too)
    k = torch.meshgrid(
        torch.fft.fftfreq(box[0], dtype=torch.float64, device=device),
        torch.fft.fftfreq(box[1], dtype=torch.float64, device=device),
        torch.fft.rfftfreq(box[2], dtype=torch.float64, device=device),
        indexing="ij")
    angle = torch.rad2deg(torch.atan2(k[projection_axis], k[q]))
    angle = torch.where(angle > 90.0, angle - 180.0, angle)
    angle = torch.where(angle <= -90.0, angle + 180.0, angle)
    lo, hi = tilt_range
    keep = (angle >= lo - 1e-9) & (angle <= hi + 1e-9)
    return keep.to(torch.float64)


def _centred(volume: torch.Tensor, shape, centre) -> torch.Tensor:
    """``volume`` in a zero volume of ``shape`` with its voxel ``centre`` at
    the origin, wrapped around the edges."""
    out = torch.zeros(shape, dtype=volume.dtype, device=volume.device)
    b = volume.shape
    out[:b[0], :b[1], :b[2]] = volume
    return torch.roll(out, shifts=tuple(-c for c in centre), dims=(0, 1, 2))


def local_sigma(tomogram, mask, centre, q=lambda t: t) -> torch.Tensor:
    """The tomogram's standard deviation under ``mask`` about each voxel,
    float64."""
    v = q(tomogram.to(torch.float64))
    shape = tuple(v.shape)
    n = float(mask.to(torch.float64).sum())
    m_ft = q(torch.fft.rfftn(_centred(mask.to(torch.float64), shape,
                                      centre))).conj()
    mean = q(torch.fft.irfftn(m_ft * q(torch.fft.rfftn(v)), s=shape) / n)
    mean_sq = q(torch.fft.irfftn(m_ft * q(torch.fft.rfftn(v * v)), s=shape)
                / n)
    return q((mean_sq - mean * mean).clamp_min(0.0).sqrt())


def match(tomogram: torch.Tensor, template: torch.Tensor,
          mask: torch.Tensor, matrices, *, tilt_range=(-60.0, 60.0),
          tilt_axis: int = 2, projection_axis: int = 0,
          interpolation: str = "filt_bspline", cval: float = 0.0,
          dtype=torch.float64):
    """(best, index, second): the best score of each voxel over
    ``matrices`` (float64), the index of the orientation that gave it
    (int64) and the second-best score."""
    q = _rounder(dtype)
    device = tomogram.device
    shape = tuple(int(s) for s in tomogram.shape)
    box = tuple(int(s) for s in template.shape)
    centre = tuple(b // 2 for b in box)
    m64 = mask.to(torch.float64)
    n = float(m64.sum())
    sigma = local_sigma(tomogram, mask, centre, q)
    floor = SIGMA_FLOOR * float(sigma.max())
    v_ft = q(torch.fft.rfftn(q(tomogram.to(torch.float64))))
    w = wedge(box, tilt_range, tilt_axis, projection_axis, device)
    coef = (resample.prefilter(template, dtype)
            if interpolation == "filt_bspline" else None)
    best = torch.full(shape, -math.inf, dtype=torch.float64, device=device)
    second = best.clone()
    index = torch.full(shape, -1, dtype=torch.int64, device=device)
    for k, m in enumerate(np.asarray(matrices, np.float32).reshape(-1, 4,
                                                                  4)):
        t = q(resample.transform(template, m, interpolation, cval, dtype,
                                 coefficients=coef).to(torch.float64))
        t = q(torch.fft.irfftn(q(torch.fft.rfftn(t)) * w, s=box))
        mean = float((t * m64).sum()) / n
        std = math.sqrt(float(((t - mean) ** 2 * m64).sum()) / n)
        t = q(m64 * (t - mean) / std) if std > 0 else torch.zeros_like(t)
        t_ft = q(torch.fft.rfftn(_centred(t, shape, centre)))
        cc = q(torch.fft.irfftn(q(t_ft.conj() * v_ft), s=shape))
        score = q(torch.where(sigma > floor, cc / (n * sigma),
                              torch.zeros((), dtype=torch.float64,
                                          device=device)))
        better = score > best
        second = torch.where(better, best, torch.maximum(second, score))
        best = torch.where(better, score, best)
        index = torch.where(better, torch.full_like(index, k), index)
    return best, index, second

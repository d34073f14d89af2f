"""Reference template matching under a mask that is not spherical:
pytom-match-pick's ``--non-spherical-mask`` path (``pytom_tm/matching.py``;
Chaillet et al., Int. J. Mol. Sci. 24:13375, 2023), Roseman's fast local
correlation function (Ultramicroscopy 94:225, 2003), in float64, one
orientation at a time.

For each 4x4 pull-back matrix about the template's centre ``c = n // 2``,
as :mod:`portbench.reference.matching` does for a fixed mask, but with
the mask rotated too: the template and the mask ``M`` rotated by
:mod:`portbench.reference.resample` (``interpolation``, 'constant',
``cval``), giving ``M_r`` and ``n_r = sum(M_r)``; the template's missing
wedge applied; the template normalised to mean 0 and standard deviation
1 under ``M_r`` and multiplied by ``M_r``; correlated with the tomogram
by FFT; divided by ``n_r sigma_r``, ``sigma_r`` the tomogram's standard
deviation under ``M_r`` about each voxel, computed anew by FFT as
:func:`portbench.reference.matching.local_sigma` computes it for a fixed
mask, 0 where ``sigma_r`` is at most ``1e-6`` of this orientation's
largest.  A voxel keeps the best score, the index of its orientation
(the first, on a tie) and the second-best score.

It imports nothing of ``voltools_tpu_torch`` or of the JAX package, batches
nothing and keeps nothing between calls.  ``dtype`` selects the control:
the rotations computed in ``dtype`` and every stored result after them
rounded to ``dtype``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import resample
from portbench.reference.matching import (SIGMA_FLOOR, _centred, _rounder,
                                          wedge)


def local_sigma(v_ft, v2_ft, mask, shape, centre, q=lambda t: t
                ) -> torch.Tensor:
    """The standard deviation under ``mask`` about each voxel of the
    tomogram whose spectrum is ``v_ft`` and its square's ``v2_ft``,
    float64."""
    n = float(mask.sum())
    m_ft = q(torch.fft.rfftn(_centred(mask, shape, centre))).conj()
    mean = q(torch.fft.irfftn(m_ft * v_ft, s=shape) / n)
    mean_sq = q(torch.fft.irfftn(m_ft * v2_ft, s=shape) / n)
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
    v = q(tomogram.to(torch.float64))
    v_ft = q(torch.fft.rfftn(v))
    v2_ft = q(torch.fft.rfftn(v * v))
    del v
    w = wedge(box, tilt_range, tilt_axis, projection_axis, device)
    cubic = interpolation == "filt_bspline"
    coef = resample.prefilter(template, dtype) if cubic else None
    mask_coef = resample.prefilter(mask, dtype) if cubic else None
    best = torch.full(shape, -math.inf, dtype=torch.float64, device=device)
    second = best.clone()
    index = torch.full(shape, -1, dtype=torch.int64, device=device)
    for k, m in enumerate(np.asarray(matrices, np.float32).reshape(-1, 4,
                                                                  4)):
        m_r = q(resample.transform(mask, m, interpolation, cval, dtype,
                                   coefficients=mask_coef).to(torch.float64))
        n = float(m_r.sum())
        sigma = local_sigma(v_ft, v2_ft, m_r, shape, centre, q)
        floor = SIGMA_FLOOR * float(sigma.max())
        t = q(resample.transform(template, m, interpolation, cval, dtype,
                                 coefficients=coef).to(torch.float64))
        t = q(torch.fft.irfftn(q(torch.fft.rfftn(t)) * w, s=box))
        mean = float((t * m_r).sum()) / n
        var = float(((t - mean) ** 2 * m_r).sum()) / n
        t = (q(m_r * (t - mean) / math.sqrt(var)) if var > 0
             else torch.zeros_like(t))
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

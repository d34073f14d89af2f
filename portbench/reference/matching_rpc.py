"""Reference template matching with pytom-match-pick's random-phase
correction (``pytom_match_template.py --random-phase-correction
--rng-seed``, ``pytom_tm/matching.py``; after STOPGAP's noise correlation,
Wan et al., Acta Cryst. D 80, 2024), in float64, one orientation at a
time.

A noise template is made from the template: its ``rfftn`` (float64, in
numpy, as pytom-match-pick computes it), the amplitudes kept,
the phases flattened and permuted by ``numpy.random.default_rng(seed)
.permutation``, ``irfftn`` back to the template's shape, kept as float32
as the template is.  For each 4x4 pull-back matrix, the template and the
noise template are each scored as :mod:`portbench.reference.matching`
scores the template under a fixed mask (with ``rotate_mask``, as
:mod:`portbench.reference.matching_nsmask` scores it under the mask
rotated with it): rotated, the missing wedge applied, normalised under
the mask and multiplied by it, correlated with the tomogram by FFT,
divided by ``n sigma`` (0 where ``sigma`` is at most ``1e-6`` of its
largest).  A voxel keeps the template's best score, the
index of its orientation (the first, on a tie) and the second-best score,
and the noise template's best score (no index); the corrected map is the
best less the noise.

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
                                          local_sigma, wedge)
from portbench.reference.matching_nsmask import local_sigma as rotated_sigma


def phase_randomised(template: torch.Tensor, seed: int) -> torch.Tensor:
    """The noise template of ``template`` (float64, on its device), in
    numpy, as pytom-match-pick makes it: the phases of the frequencies
    whose amplitude is at the transform's rounding are that rounding's, and
    they are permuted onto frequencies that matter, so only numpy's own
    transforms give its template."""
    t = template.detach().cpu().numpy().astype(np.float64)
    ft = np.fft.rfftn(t)
    phase = np.random.default_rng(int(seed)).permutation(
        np.angle(ft).reshape(-1)).reshape(ft.shape)
    noise = np.fft.irfftn(np.abs(ft) * np.exp(1j * phase), s=t.shape,
                          axes=(0, 1, 2))
    return torch.from_numpy(noise).to(template.device)


def match(tomogram: torch.Tensor, template: torch.Tensor,
          mask: torch.Tensor, matrices, *, tilt_range=(-60.0, 60.0),
          tilt_axis: int = 2, projection_axis: int = 0,
          interpolation: str = "filt_bspline", cval: float = 0.0,
          rng_seed: int = 321, rotate_mask: bool = False,
          dtype=torch.float64):
    """(best, index, second, noise, corrected): the template's best score
    of each voxel over ``matrices`` (float64), the index of the
    orientation that gave it (int64), the second-best score, the noise
    template's best score and ``best - noise``.  With ``rotate_mask`` the
    mask is rotated with the templates and the local sigma taken under
    the rotated mask each orientation, as
    :mod:`portbench.reference.matching_nsmask` takes it."""
    q = _rounder(dtype)
    device = tomogram.device
    shape = tuple(int(s) for s in tomogram.shape)
    box = tuple(int(s) for s in template.shape)
    centre = tuple(b // 2 for b in box)
    cubic = interpolation == "filt_bspline"
    if not rotate_mask:
        weights = mask.to(torch.float64)
        terms = _terms(local_sigma(tomogram, mask, centre, q),
                       float(weights.sum()))
    v = q(tomogram.to(torch.float64))
    v_ft = q(torch.fft.rfftn(v))
    if rotate_mask:
        v2_ft = q(torch.fft.rfftn(v * v))
        mask_coef = resample.prefilter(mask, dtype) if cubic else None
    del v
    w = wedge(box, tilt_range, tilt_axis, projection_axis, device)
    noise_t = phase_randomised(template, rng_seed).to(torch.float32)
    sources = [(source, resample.prefilter(source, dtype) if cubic else None)
               for source in (template, noise_t)]

    def score(source, coefficients, m, weights, n, n_sigma, low):
        t = q(resample.transform(source, m, interpolation, cval, dtype,
                                 coefficients=coefficients).to(torch.float64))
        t = q(torch.fft.irfftn(q(torch.fft.rfftn(t)) * w, s=box))
        mean = float((t * weights).sum()) / n
        var = float(((t - mean) ** 2 * weights).sum()) / n
        t = (q(weights * (t - mean) / math.sqrt(var)) if var > 0
             else torch.zeros_like(t))
        t_ft = q(torch.fft.rfftn(_centred(t, shape, centre)))
        cc = q(torch.fft.irfftn(q(t_ft.conj_physical_().mul_(v_ft)),
                                s=shape))
        del t_ft
        return q(cc.div_(n_sigma).masked_fill_(low, 0.0))

    best = torch.full(shape, -math.inf, dtype=torch.float64, device=device)
    second = best.clone()
    noise = best.clone()
    index = torch.full(shape, -1, dtype=torch.int64, device=device)
    for k, m in enumerate(np.asarray(matrices, np.float32).reshape(-1, 4,
                                                                  4)):
        if rotate_mask:
            weights = q(resample.transform(
                mask, m, interpolation, cval, dtype,
                coefficients=mask_coef).to(torch.float64))
            terms = _terms(rotated_sigma(v_ft, v2_ft, weights, shape,
                                         centre, q), float(weights.sum()))
        s = score(*sources[0], m, weights, *terms)
        better = s > best
        torch.maximum(second, s, out=second)
        second = torch.where(better, best, second)
        best = torch.where(better, s, best)
        index.masked_fill_(better, k)
        del s, better
        torch.maximum(noise, score(*sources[1], m, weights, *terms),
                      out=noise)
    return best, index, second, noise, best - noise


def _terms(sigma: torch.Tensor, n: float):
    """(n, n sigma, where sigma is at most its floor) of a local sigma
    map under a mask of weight ``n``; ``sigma`` is taken over."""
    low = sigma <= SIGMA_FLOOR * float(sigma.max())
    return n, sigma.mul_(n), low

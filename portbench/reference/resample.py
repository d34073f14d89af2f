"""Reference affine resample: scipy.ndimage's ``affine_transform`` with
``order=1`` or ``order=3, prefilter=True`` in ``mode='constant'``.

* Coordinates: a 4x4 float32 pull-back matrix maps output voxel (i, j, k)
  to the source point ``s_a = ((m[a,0] i + m[a,1] j) + m[a,2] k) +
  m[a,3]``, evaluated in float32 with one rounding per operation: the
  library's coordinate map takes float32 matrices and float32 coordinates,
  so a point's floor and its in-range test are those of these float32
  values.  Everything after is computed in ``dtype``.
* A point outside [0, n - 1] on any axis gives ``cval``; inside, linear
  taps are clamped (the +1 tap at n - 1 has weight 0) and cubic taps that
  poke past an edge are mirror-reflected (scipy's 'constant' mode).
* The prefilter is the exact cubic B-spline inversion (Unser 1999;
  Thevenaz et al. 2000): a causal and an anticausal recursion per axis
  with pole sqrt(3) - 2, mirror boundary (scipy's ``spline_filter``), the
  causal start summed over the whole mirrored period.
"""

from __future__ import annotations

import math

import numpy as np
import torch

POLE = math.sqrt(3.0) - 2.0
VOXELS_PER_BLOCK = 1 << 22


def prefilter(volume: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Cubic B-spline coefficients of ``volume`` along all three axes."""
    c = volume.to(dtype)
    for axis in range(3):
        c = _prefilter_axis(c, axis)
    return c


def _prefilter_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    x = c.movedim(axis, 0)
    n = x.shape[0]
    if n < 2:
        return c
    z = POLE
    k = np.arange(n, dtype=np.float64)
    # the mirrored signal has period 2n - 2: x[k] enters the causal start
    # with z^k, and again with z^(2n-2-k) for 0 < k < n - 1
    w = z ** k
    w[1:n - 1] += z ** (2 * n - 2 - k[1:n - 1])
    w /= 1.0 - z ** (2 * n - 2)
    w = torch.as_tensor(w, dtype=c.dtype, device=c.device)
    shape = (n,) + (1,) * (x.ndim - 1)
    causal = torch.empty_like(x)
    causal[0] = (w.view(shape) * x).sum(0)
    for i in range(1, n):
        causal[i] = x[i] + z * causal[i - 1]
    out = torch.empty_like(x)
    out[n - 1] = (z / (z * z - 1.0)) * (causal[n - 1] + z * causal[n - 2])
    for i in range(n - 2, -1, -1):
        out[i] = z * (out[i + 1] - causal[i])
    return (6.0 * out).movedim(0, axis).contiguous()


def _cubic_weights(f):
    g = 1.0 - f
    return (g * g * g / 6.0, 2.0 / 3.0 - 0.5 * f * f * (2.0 - f),
            2.0 / 3.0 - 0.5 * g * g * (2.0 - g), f * f * f / 6.0)


def _mirror(idx, n: int):
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def coordinates(shape, matrix, planes, device):
    """The float32 source coordinates (3 tensors) of output planes
    ``planes`` (a range along axis 0) of an output of ``shape``."""
    m = torch.as_tensor(np.asarray(matrix, np.float32), device=device)
    _, d1, d2 = shape
    i = torch.arange(planes.start, planes.stop, dtype=torch.float32,
                     device=device).view(-1, 1, 1)
    j = torch.arange(d1, dtype=torch.float32, device=device).view(1, -1, 1)
    k = torch.arange(d2, dtype=torch.float32, device=device).view(1, 1, -1)
    return [((m[a, 0] * i + m[a, 1] * j) + m[a, 2] * k) + m[a, 3]
            for a in range(3)]


def resample(source: torch.Tensor, matrix, order: int, cval: float = 0.0,
             dtype=torch.float64) -> torch.Tensor:
    """``source`` (samples for order 1, coefficients for order 3) resampled
    through ``matrix`` onto its own grid, in ``dtype``, block by block."""
    shape = tuple(int(s) for s in source.shape)
    d0, d1, d2 = shape
    flat = source.to(dtype).reshape(-1)
    out = torch.empty(shape, dtype=dtype, device=source.device)
    step = max(1, VOXELS_PER_BLOCK // (d1 * d2))
    for z0 in range(0, d0, step):
        planes = range(z0, min(d0, z0 + step))
        s = coordinates(shape, matrix, planes, source.device)
        inside = torch.ones_like(s[0], dtype=torch.bool)
        taps = []
        for a, n in enumerate(shape):
            inside &= (s[a] >= 0) & (s[a] <= n - 1)
            fl = torch.floor(s[a])
            f = (s[a] - fl).to(dtype)
            base = fl.to(torch.int64)
            if order == 1:
                taps.append([((base + t).clamp(0, n - 1), w)
                             for t, w in enumerate((1.0 - f, f))])
            else:
                taps.append([(_mirror(base + t - 1, n), w)
                             for t, w in enumerate(_cubic_weights(f))])
        acc = torch.zeros(s[0].shape, dtype=dtype, device=source.device)
        for iz, wz in taps[0]:
            for iy, wy in taps[1]:
                wzy = wz * wy
                row = (iz * d1 + iy) * d2
                for ix, wx in taps[2]:
                    acc += wzy * wx * flat[row + ix]
        out[planes.start:planes.stop] = torch.where(
            inside, acc, torch.tensor(cval, dtype=dtype, device=acc.device))
    return out


def transform(volume: torch.Tensor, matrix, interpolation: str,
              cval: float = 0.0, dtype=torch.float64, coefficients=None):
    """scipy's ``affine_transform`` of ``volume`` in 'constant' mode:
    'linear' (order 1) or 'filt_bspline' (order 3 on the prefiltered
    volume; ``coefficients`` reuses a prefilter already computed)."""
    if interpolation == "linear":
        return resample(volume, matrix, 1, cval, dtype)
    if interpolation == "filt_bspline":
        if coefficients is None:
            coefficients = prefilter(volume, dtype)
        return resample(coefficients, matrix, 3, cval, dtype)
    raise ValueError(f"no reference for interpolation {interpolation!r}")

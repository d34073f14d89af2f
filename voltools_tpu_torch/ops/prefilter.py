"""Cubic B-spline prefilter (samples -> interpolation coefficients).

The port's counterpart of ``voltools_tpu/ops/prefilter.py``.  True cubic
B-spline *interpolation* inverts the B-spline basis: a causal + anticausal
first-order IIR per axis with pole ``p = sqrt(3) - 2``.  Two formulations:

* ``method='fir'`` (default, mirror boundary only) - the composed filter is
  an LTI system with impulse response ``h[n] = sqrt(3) * p**|n|``; truncated
  where ``|p|**K`` is far below float32 resolution, each axis becomes a
  banded-Toeplitz matrix product, run in true float32 (TF32 off, the
  analogue of the JAX package's ``precision=HIGHEST``).
* ``method='scan'`` - the exact recursions, as a loop over the axis on whole
  planes (torch has no associative scan).  ``'clamp'`` always takes it.

Boundary handling:

* ``'mirror'`` - scipy-compatible (``scipy.ndimage.spline_filter`` with
  ``mode='mirror'``); the default, so ``filt_bspline`` matches
  ``scipy.ndimage.affine_transform``.
* ``'clamp'`` - edge replication, matching the reference GPU kernels'
  initialisation (``bspline.h:7-19``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.general import full_fp32_matmul

POLE = float(np.sqrt(3.0) - 2.0)
# gain of the causal/anticausal cascade: (1-p)(1-1/p)
LAMBDA = float((1.0 - POLE) * (1.0 - 1.0 / POLE))
# number of taps after which p**K is far below float32 resolution
_HORIZON = 28
_FIR_HALF_WIDTH = 18

BOUNDARIES = ("mirror", "clamp")

# float32 constants of the recursions, rounded as float32 arithmetic gives
# them (the JAX package evaluates these expressions on float32 scalars)
_P32 = np.float32(POLE)
_MIRROR_TAIL = float(_P32 / (_P32 * _P32 - np.float32(1.0)))
_CLAMP_TAIL = float(_P32 / (_P32 - np.float32(1.0)))


def _causal_init(x, boundary):
    """Initial causal coefficient (pre-gain) of lines laid along axis 0."""
    n = x.shape[0]
    # mirror reads x[1..h]; clamp reads x[0..h-1] so it can use all n samples
    h = min(_HORIZON, n - 1 if boundary == "mirror" else n)
    if h == 0:
        return x[0]
    powers = torch.as_tensor(
        (POLE ** np.arange(1, h + 1, dtype=np.float64)).astype(np.float32),
        device=x.device)
    # mirror extension x[-k] = x[k]:  c0 = x0 + sum_k p^k x[k]
    # clamp extension x[-1] = x[0]:   c0 = x0 + sum_k p^k x[k-1]
    window = x[1:h + 1] if boundary == "mirror" else x[0:h]
    shape = (h,) + (1,) * (x.ndim - 1)
    return x[0] + torch.sum(window * powers.reshape(shape), dim=0)


def prefilter_scan(volume, axis: int, boundary: str = "mirror"):
    """One exact causal+anticausal IIR pass along ``axis``."""
    n = volume.shape[axis]
    if n < 2:
        return volume
    x = torch.movedim(volume, axis, 0)

    # causal: c[0] = lam * init;  c[k] = lam*x[k] + p*c[k-1]
    c = [LAMBDA * _causal_init(x, boundary)]
    for k in range(1, n):
        c.append(POLE * c[-1] + LAMBDA * x[k])

    # anticausal: runs backwards, c'[k] = p*(c'[k+1] - c[k])
    if boundary == "mirror":
        tail = _MIRROR_TAIL * (c[n - 1] + POLE * c[n - 2])
    else:
        tail = _CLAMP_TAIL * c[n - 1]  # reference bspline.h:21-28
    out = [None] * n
    out[n - 1] = tail
    for k in range(n - 2, -1, -1):
        out[k] = POLE * out[k + 1] + (-POLE) * c[k]
    return torch.movedim(torch.stack(out), 0, axis)


@functools.lru_cache(maxsize=32)
def _fir_matrix(n: int, half_width: int, boundary: str):
    """Dense (n, n) matrix applying the truncated inverse-B-spline filter
    with the boundary extension folded in.  h[k] = sqrt(3) * p^|k|."""
    k = half_width
    taps = np.sqrt(3.0) * POLE ** np.abs(np.arange(-k, k + 1, dtype=np.float64))
    ext = np.zeros((n + 2 * k, n), dtype=np.float64)
    for row in range(n + 2 * k):
        src = row - k
        if boundary == "mirror":
            # periodic reflection (handles overhangs larger than one period,
            # which small axes hit)
            if n > 1:
                src = src % (2 * (n - 1))
                if src >= n:
                    src = 2 * (n - 1) - src
            else:
                src = 0
        else:
            src = min(max(src, 0), n - 1)
        ext[row, src] = 1.0
    conv = np.zeros((n, n + 2 * k), dtype=np.float64)
    for row in range(n):
        conv[row, row:row + 2 * k + 1] = taps
    return (conv @ ext).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _fir_weights(n: int, boundary: str, device: torch.device):
    """:func:`_fir_matrix` as a tensor on ``device``, copied there once per
    (n, boundary, device), so a prefilter pass makes no host copy."""
    return torch.as_tensor(_fir_matrix(n, _FIR_HALF_WIDTH, boundary),
                           device=device)


def prefilter_fir(volume, axis: int, boundary: str = "mirror"):
    """One prefilter pass along ``axis`` as a Toeplitz matrix product.

    Mirror boundary only: the FIR formulation assumes the boundary
    extension commutes with the causal/anticausal cascade, which fails for
    the clamped anticausal initialisation (~5e-2 edge error) - use
    :func:`prefilter_scan` (or :func:`bspline_prefilter`, which routes
    automatically) for ``'clamp'``."""
    if boundary != "mirror":
        raise ValueError(
            f"prefilter_fir supports boundary='mirror' only (got "
            f"{boundary!r}); use prefilter_scan or bspline_prefilter")
    n = volume.shape[axis]
    if n < 2:
        return volume
    w = _fir_weights(n, boundary, volume.device)
    moved = torch.movedim(volume, axis, -1)
    # TF32 keeps ~3 decimal digits and breaks scipy parity of the filtered
    # coefficients: the product runs in full float32
    with full_fp32_matmul():
        out = torch.matmul(moved, w.T)
    return torch.movedim(out, -1, axis)


def bspline_prefilter(volume, boundary: str = "mirror", method: str = "fir"):
    """Convert samples to cubic B-spline coefficients along all three axes.

    Equivalent of the reference's three ``SamplesToCoefficients3D{X,Y,Z}``
    launches (``transforms.py:290-309``).  Returns a contiguous float32
    tensor on the volume's device."""
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary must be one of {BOUNDARIES}")
    volume = torch.as_tensor(volume, dtype=torch.float32)
    fn = (prefilter_fir if (method == "fir" and boundary == "mirror")
          else prefilter_scan)
    for axis in range(volume.ndim):
        volume = fn(volume, axis, boundary)
    return volume.contiguous()

"""Interpolation (plain PyTorch reference implementations).

Samples a 3-D volume at arbitrary fractional coordinates.  These are the
port's counterparts of ``voltools_tpu/ops/interpolation.py``: the CPU path,
the autograd path and the plain version every CUDA kernel is held against.

Interpolation modes (reference ``voltools/transforms.py:11-17``):

* ``linear`` - trilinear (scipy ``order=1``)
* ``bspline`` / ``bspline_simple`` - cubic B-spline weighting of the raw
  samples (scipy ``order=3, prefilter=False``); both names run the same
  exact 64-tap separable contraction.
* ``filt_bspline`` / ``filt_bspline_simple`` - as above, on a prefiltered
  volume (scipy ``order=3, prefilter=True``); prefiltering lives in
  :mod:`voltools_tpu_torch.ops.prefilter`.

Boundary handling (``mode``):

* ``'constant'`` (default) - scipy-compatible: any sample point outside
  ``[0, n-1]`` on any axis returns ``cval``; in-range cubic taps that poke
  past the edge are mirror-reflected, matching ``scipy.ndimage``.
* ``'border'`` - CUDA-texture-style: out-of-range taps contribute zero, and
  points are discarded only half a voxel past the edge.

Flat gather indices are int64, so volumes past 2**31 voxels index correctly.
"""

from __future__ import annotations

import torch

AVAILABLE_INTERPOLATIONS = [
    "linear",
    "bspline",
    "bspline_simple",
    "filt_bspline",
    "filt_bspline_simple",
]

MODES = ("constant", "border")


def spline_order(interpolation: str) -> int:
    if interpolation == "linear":
        return 1
    if interpolation in AVAILABLE_INTERPOLATIONS:
        return 3
    raise ValueError(
        f"Interpolation must be one of {AVAILABLE_INTERPOLATIONS}, got {interpolation!r}")


def needs_prefilter(interpolation: str) -> bool:
    return interpolation.startswith("filt_bspline")


def cubic_bspline_weights(f):
    """The four cubic B-spline tap weights for fractional offset ``f``.

    Taps sit at ``floor(s)-1 .. floor(s)+2`` (reference
    ``kernels/bspline.h:102-112``)."""
    g = 1.0 - f
    f2 = f * f
    g2 = g * g
    w0 = (1.0 / 6.0) * g2 * g
    w1 = 2.0 / 3.0 - 0.5 * f2 * (2.0 - f)
    w2 = 2.0 / 3.0 - 0.5 * g2 * (2.0 - g)
    w3 = (1.0 / 6.0) * f2 * f
    return w0, w1, w2, w3


def _mirror_index(idx, n: int):
    """scipy 'mirror' reflection (no edge repeat): ... 2 1 | 0 1 2 | 1 0 ...

    ``torch.remainder`` takes the sign of the divisor, as ``jnp.remainder``
    does, so negative indices fold correctly."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def _flat_gather(flat_vol, z, y, x, shape):
    _, d1, d2 = shape
    return torch.take(flat_vol, (z * d1 + y) * d2 + x)


def _inside(sz, sy, sx, shape, mode):
    d0, d1, d2 = shape
    if mode == "constant":
        return ((sz >= 0) & (sz <= d0 - 1) & (sy >= 0) & (sy <= d1 - 1)
                & (sx >= 0) & (sx <= d2 - 1))
    # 'border' keeps blended edge values; discard half a voxel past the edge
    return ((sz > -0.5) & (sz < d0 - 0.5) & (sy > -0.5) & (sy < d1 - 0.5)
            & (sx > -0.5) & (sx < d2 - 0.5))


def sample_linear(volume, coords, mode: str = "constant", cval: float = 0.0):
    """Trilinear sampling. ``coords``: (3, ...) fractional source coordinates."""
    d0, d1, d2 = volume.shape
    sz, sy, sx = coords[0], coords[1], coords[2]
    z0f, y0f, x0f = torch.floor(sz), torch.floor(sy), torch.floor(sx)
    fz, fy, fx = sz - z0f, sy - y0f, sx - x0f
    z0 = z0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)

    flat = volume.reshape(-1)

    def tap(dz, dy, dx):
        z, y, x = z0 + dz, y0 + dy, x0 + dx
        # 'constant' clips: an in-range point's +1 tap at exactly n-1 has
        # weight 0 but must still index inside the volume
        v = _flat_gather(flat, z.clamp(0, d0 - 1), y.clamp(0, d1 - 1),
                         x.clamp(0, d2 - 1), volume.shape)
        if mode == "constant":
            return v
        # 'border': each out-of-range tap contributes zero
        ok = ((z >= 0) & (z < d0) & (y >= 0) & (y < d1) & (x >= 0)
              & (x < d2))
        return torch.where(ok, v, 0.0)

    out = torch.zeros_like(sz)
    for dz in (0, 1):
        wz = fz if dz else 1.0 - fz
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dx in (0, 1):
                wx = fx if dx else 1.0 - fx
                out = out + wz * wy * wx * tap(dz, dy, dx)
    return torch.where(_inside(sz, sy, sx, volume.shape, mode), out, cval)


def sample_cubic(volume, coords, mode: str = "constant", cval: float = 0.0):
    """Cubic B-spline sampling (64 taps, separable weights).

    Apply to a prefiltered volume for true order-3 interpolation
    (= scipy ``order=3, prefilter=True``) or to the raw volume for the
    smoothing variants (= scipy ``order=3, prefilter=False``).
    """
    d0, d1, d2 = volume.shape
    sz, sy, sx = coords[0], coords[1], coords[2]
    z0f, y0f, x0f = torch.floor(sz), torch.floor(sy), torch.floor(sx)
    wz = cubic_bspline_weights(sz - z0f)
    wy = cubic_bspline_weights(sy - y0f)
    wx = cubic_bspline_weights(sx - x0f)

    def tap_indices(base, n):
        """Per tap: (index inside the volume, validity mask or None)."""
        taps = []
        for d in range(4):
            idx = base + (d - 1)
            if mode == "constant":
                taps.append((_mirror_index(idx, n), None))
            else:
                taps.append((idx.clamp(0, n - 1), (idx >= 0) & (idx < n)))
        return taps

    tz = tap_indices(z0f.to(torch.int64), d0)
    ty = tap_indices(y0f.to(torch.int64), d1)
    tx = tap_indices(x0f.to(torch.int64), d2)

    flat = volume.reshape(-1)
    out = torch.zeros_like(sz)
    for dz in range(4):
        z, okz = tz[dz]
        for dy in range(4):
            y, oky = ty[dy]
            w_zy = wz[dz] * wy[dy]
            for dx in range(4):
                x, okx = tx[dx]
                v = _flat_gather(flat, z, y, x, volume.shape)
                if mode == "border":
                    v = torch.where(okz & oky & okx, v, 0.0)
                out = out + w_zy * wx[dx] * v
    return torch.where(_inside(sz, sy, sx, volume.shape, mode), out, cval)


def sample(volume, coords, interpolation: str = "linear",
           mode: str = "constant", cval: float = 0.0, prefiltered: bool = False):
    """Dispatch by interpolation name. ``prefiltered=True`` means the caller
    already converted the volume to B-spline coefficients (StaticVolume does
    this once at construction, mirroring reference ``volume.py:48-50``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    order = spline_order(interpolation)
    if order == 1:
        return sample_linear(volume, coords, mode, cval)
    if needs_prefilter(interpolation) and not prefiltered:
        from .prefilter import bspline_prefilter
        volume = bspline_prefilter(volume, boundary="mirror")
    return sample_cubic(volume, coords, mode, cval)

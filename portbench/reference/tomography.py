"""Reference tomography: the tilt-series forward model, its back-projection,
WBP and SIRT, as sparse system matrices in float64.

The geometry is a single-axis tilt series about array axis 2, projected
along axis 0 (a tomogram's z): each pull-back matrix M leaves x alone
(``M[2] = (0, 0, 1, 0)``, ``M[0:2, 2] = 0``) and turns the (z, y) plane.
x is then a batch axis, and each operator is one sparse matrix acting on
the volume's (z, y) rows:

* forward ``A``: projection t, row j, is the sum over the output planes i
  of the trilinear sample of the volume at ``(s_0, s_1, x)``, ``s_a =
  ((M[a,0] i + M[a,1] j) + M[a,2] x) + M[a,3]`` in float32 (the library's
  coordinate map; M[a,2] = 0), zero where s lies outside [0, n - 1]
  ('constant'), taps clamped inside; x is integral, so a sample is the
  bilinear one of its (z, y) plane.
* back-projection ``B``: voxel (z, y, x) sums over the tilts the linear
  sample of projection t's row coordinate ``r = (M^-1)[1] . (z, y, x, 1)``
  (M^-1 in float64) at column x; a row tap outside the projection counts
  0.  It is the library's adjoint operator, not the transpose of ``A``.
* WBP: the ramp |f| along the rows (across the tilt axis), then ``B``,
  times pi / N.
* SIRT: ``x += relax C B R (p - A x)``, R and C the inverse row and column
  sums (``A 1`` and ``B 1``), zero where a sum is at most 1e-6.

``q`` rounds every stored result (the control's bfloat16), and the
matrices' weights with it; sums of products are accumulated in float64.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

EPS = 1e-6


def _check_geometry(matrices: np.ndarray):
    m = np.asarray(matrices, np.float32)
    if m.ndim != 3 or m.shape[1:] != (4, 4):
        raise ValueError(f"expected (N, 4, 4) matrices, got {m.shape}")
    if not ((m[:, 2] == np.float32([0, 0, 1, 0])).all()
            and (m[:, 0:2, 2] == 0).all()):
        raise NotImplementedError(
            "the reference takes single-axis tilt series about array axis "
            "2 only")
    return m


class TiltSeries:
    """The forward and back-projection operators of ``matrices`` for a
    volume of ``out_shape``, projected along axis 0, as sparse float64
    CSR matrices on ``device``."""

    def __init__(self, matrices, out_shape, device, q=None):
        self.m = _check_geometry(matrices)
        self.shape = tuple(int(s) for s in out_shape)
        self.device = device
        self.q = q or (lambda t: t)
        self._a = self._b = None

    @property
    def n(self) -> int:
        return len(self.m)

    @property
    def proj_shape(self):
        return self.shape[1:]

    # -- the operators --------------------------------------------------

    def forward_matrix(self):
        """A: (N * D1, D0 * D1); rows (tilt, projection row j), columns
        the volume's (z, y) rows."""
        if self._a is None:
            d0, d1, _ = self.shape
            dev = self.device
            i = torch.arange(d0, dtype=torch.float32, device=dev).view(-1, 1)
            j = torch.arange(d1, dtype=torch.float32, device=dev).view(1, -1)
            rows, cols, vals = [], [], []
            for t, mt in enumerate(torch.as_tensor(self.m, device=dev)):
                s = [(mt[a, 0] * i + mt[a, 1] * j) + mt[a, 3]
                     for a in range(2)]
                inside = ((s[0] >= 0) & (s[0] <= d0 - 1) & (s[1] >= 0)
                          & (s[1] <= d1 - 1))
                fl = [torch.floor(c) for c in s]
                f = [(c - b).to(torch.float64) for c, b in zip(s, fl)]
                base = [b.to(torch.int64) for b in fl]
                row = (t * d1 + torch.arange(d1, device=dev)).expand(d0, d1)
                for a in (0, 1):
                    for b in (0, 1):
                        w = ((f[0] if a else 1.0 - f[0])
                             * (f[1] if b else 1.0 - f[1]))
                        keep = inside & (w != 0)
                        zc = (base[0] + a).clamp(0, d0 - 1)
                        yc = (base[1] + b).clamp(0, d1 - 1)
                        rows.append(row[keep])
                        cols.append((zc * d1 + yc)[keep])
                        vals.append(w[keep])
            self._a = _csr(rows, cols, vals, (self.n * d1, d0 * d1), self.q)
        return self._a

    def backproject_matrix(self):
        """B: (D0 * D1, N * H'); rows the volume's (z, y) rows, columns
        (tilt, projection row)."""
        if self._b is None:
            d0, d1, _ = self.shape
            h = self.proj_shape[0]
            dev = self.device
            minv = np.linalg.inv(self.m.astype(np.float64))
            if np.abs(minv[:, 1, 2]).max() > 1e-12:
                raise NotImplementedError("rows depend on x")
            z = torch.arange(d0, dtype=torch.float64, device=dev).view(-1, 1)
            y = torch.arange(d1, dtype=torch.float64, device=dev).view(1, -1)
            vox = (z * d1 + y).to(torch.int64)
            rows, cols, vals = [], [], []
            for t, mi in enumerate(minv):
                r = float(mi[1, 0]) * z + float(mi[1, 1]) * y + float(mi[1, 3])
                fl = torch.floor(r)
                fr = r - fl
                r0 = fl.to(torch.int64)
                for tap, w in ((r0, 1.0 - fr), (r0 + 1, fr)):
                    keep = (tap >= 0) & (tap < h) & (w != 0)
                    rows.append(vox.expand(d0, d1)[keep])
                    cols.append((t * h + tap)[keep])
                    vals.append(w[keep])
            self._b = _csr(rows, cols, vals, (d0 * d1, self.n * h), self.q)
        return self._b

    def project(self, volume: torch.Tensor) -> torch.Tensor:
        """A x: (N, D1, D2) projections of a (D0, D1, D2) volume."""
        d0, d1, d2 = self.shape
        p = self.forward_matrix() @ self.q(
            volume.to(torch.float64).reshape(d0 * d1, d2))
        return self.q(p).reshape(self.n, d1, d2)

    def backproject(self, projections: torch.Tensor) -> torch.Tensor:
        """B p: the (D0, D1, D2) back-projection of (N, H', W')."""
        h, w = projections.shape[1:]
        v = self.backproject_matrix() @ self.q(
            projections.to(torch.float64).reshape(self.n * h, w))
        return self.q(v).reshape(self.shape)


def _csr(rows, cols, vals, size, q):
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    coo = torch.sparse_coo_tensor(idx, q(torch.cat(vals)), size,
                                  dtype=torch.float64,
                                  check_invariants=False).coalesce()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "in beta state"
        return coo.to_sparse_csr()


def ramp(projections: torch.Tensor, q=None) -> torch.Tensor:
    """The Ram-Lak ramp |f| along the projection rows (axis 1 of an
    (N, H', W') stack), across the tilt axis x."""
    q = q or (lambda t: t)
    p = q(projections.to(torch.float64))
    h = p.shape[1]
    freqs = torch.fft.fftfreq(h, dtype=torch.float64, device=p.device)
    f = torch.fft.fft(p, dim=1) * freqs.abs().view(1, -1, 1)
    return q(torch.fft.ifft(f, dim=1).real)


def wbp(series: TiltSeries, projections: torch.Tensor) -> torch.Tensor:
    """Weighted back-projection, scaled by pi / N."""
    return series.q(series.backproject(ramp(projections, series.q))
                    * (math.pi / series.n))


def sirt(series: TiltSeries, projections: torch.Tensor, iterations: int,
         relax: float = 1.0) -> torch.Tensor:
    """SIRT from a zero volume, ``iterations`` updates."""
    q = series.q
    d0, d1, d2 = series.shape
    p = q(projections.to(torch.float64))
    ones_v = torch.ones(series.shape, dtype=torch.float64,
                        device=p.device)
    row_sum = series.project(ones_v)
    col_sum = series.backproject(torch.ones_like(p))
    rinv = q(torch.where(row_sum > EPS, 1.0 / row_sum, 0.0))
    cinv = q(torch.where(col_sum > EPS, 1.0 / col_sum, 0.0))
    x = torch.zeros(series.shape, dtype=torch.float64, device=p.device)
    for _ in range(iterations):
        resid = q((p - series.project(x)) * rinv)
        x = q(x + q(relax * cinv * series.backproject(resid)))
    return x

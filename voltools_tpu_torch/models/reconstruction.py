"""Weighted back-projection and SIRT: the inverse of the tilt-series model.

The port's counterpart of ``voltools_tpu/models/reconstruction.py``.
:class:`~.projections.TiltSeriesProjector` computes ``p_m(y, x) = sum_z
vol(M (z, y, x))`` per tilt matrix ``M``.  The adjoint of (rotate by M, sum
over z) reads each projection at the (row, col) part of ``M^-1 w`` for every
output voxel ``w``: reconstruction ramp-filters each projection across the
tilt axis, back-projects it along the matching geometry, and sums.

The ramp filter is ``torch.fft`` along one projection axis; the
back-projection is a Python loop over tilts (the JAX package's
``lax.scan``) of a 2-D bilinear gather, or of two whole-row gathers for a
single-axis tilt series.  SIRT's forward operator is the projector's
batched kernel sweep (:func:`.projections.project_stack`), run once per
iteration.  The JAX package's mesh modes (``mesh=``, ``mesh_shard=``) are
not in the port yet.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..kernels.layout import pitched, pitched_empty
from ..transforms import _as_tensor, _device, _finish
from .projections import _norm_axis, plain_project_stack, project_stack

__all__ = ["ramp_filter", "sirt_reconstruct", "wbp_reconstruct"]


def ramp_filter(projections, axis: int = -1, window: str = "ramlak"):
    """Frequency-domain ramp filter |f| along ``axis``; a float32 tensor on
    the projections' device (the CPU for a numpy array).

    ``window``: 'ramlak' (plain |f|) or 'hamming' (|f| tapered by a Hamming
    window, which damps the high-frequency noise amplification)."""
    if window not in ("ramlak", "hamming"):
        raise ValueError(f"unknown window {window!r}")
    projections = torch.as_tensor(projections, dtype=torch.float32)
    n = projections.shape[axis]
    freqs = torch.fft.fftfreq(n, dtype=torch.float32,
                              device=projections.device)
    ramp = freqs.abs()
    if window == "hamming":
        ramp = ramp * (0.54 + 0.46 * torch.cos(2.0 * math.pi * freqs))
    shape = [1] * projections.ndim
    shape[axis] = n
    f = torch.fft.fft(projections, dim=axis)
    out = torch.fft.ifft(f * ramp.reshape(shape), dim=axis)
    return out.real.to(torch.float32).contiguous()


def _result_out(result: torch.Tensor, output):
    """The output contract for reconstructions: None -> host numpy;
    'device' -> the tensor; a numpy buffer -> validated fill (returns
    None).  Any other string is an error."""
    if isinstance(output, str):
        if output == "device":
            return result
        raise ValueError(
            f"output must be None, 'device', or a numpy array to fill, "
            f"got {output!r}")
    return _finish(result.cpu().numpy(), output)


def _bilinear2d(img, yy, xx):
    """Bilinear sample of a 2-D image at float coordinate tensors (any
    shape); out-of-range taps contribute 0."""
    h, w = img.shape
    y0f = torch.floor(yy)
    x0f = torch.floor(xx)
    fy = yy - y0f
    fx = xx - x0f
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)

    def tap(yt, xt, wgt):
        valid = (yt >= 0) & (yt < h) & (xt >= 0) & (xt < w)
        v = img[yt.clamp(0, h - 1), xt.clamp(0, w - 1)]
        return torch.where(valid, v, 0.0) * wgt

    return (tap(y0, x0, (1 - fy) * (1 - fx))
            + tap(y0, x0 + 1, (1 - fy) * fx)
            + tap(y0 + 1, x0, fy * (1 - fx))
            + tap(y0 + 1, x0 + 1, fy * fx))


def _make_adjoint(minv, keep, out_shape, proj_shape,
                  _force_general: bool = False):
    """The back-projection ``(projs, minvs) -> volume`` shared by WBP and
    SIRT; ``projs`` is an (N, H', W') tensor, ``minvs`` the (N, 4, 4) numpy
    inverse matrices.

    General geometry: per tilt, a 2-D bilinear gather of the projection at
    (rows, cols) = the ``keep`` components of ``M^-1 w``.  A single-axis
    tilt series (cols the identity coordinate of one volume axis, rows
    independent of it; every ``tilt_matrices`` stack) takes a fast path:
    the gather is two whole-row gathers per tilt."""
    ax_c = keep[1]
    ident = np.zeros(4, np.float32)
    ident[ax_c] = 1.0
    rowgather = (not _force_general
                 and np.abs(minv[:, ax_c, :] - ident).max() < 1e-6
                 and np.abs(minv[:, keep[0], ax_c]).max() < 1e-6
                 and out_shape[ax_c] == proj_shape[1])
    dep = [a for a in range(3) if a != ax_c]
    perm = tuple(int(i) for i in np.argsort(dep + [ax_c]))

    def grid(n, axis, ndim, device):
        view = [1] * ndim
        view[axis] = n
        return torch.arange(n, dtype=torch.float32, device=device).view(view)

    def adjoint(projs, minvs):
        device = projs.device
        acc = torch.zeros(out_shape, dtype=torch.float32, device=device)
        if rowgather:
            sh2 = (out_shape[dep[0]], out_shape[dep[1]])
            i0 = grid(sh2[0], 0, 2, device)
            i1 = grid(sh2[1], 1, 2, device)
            h = proj_shape[0]
            for proj, mi in zip(projs, minvs):
                r = [float(v) for v in mi[keep[0]]]
                rows = r[dep[0]] * i0 + r[dep[1]] * i1 + r[3]
                r0f = torch.floor(rows)
                fr = rows - r0f
                r0 = r0f.to(torch.int64)

                def rtap(rt, wgt):
                    valid = (rt >= 0) & (rt < h)
                    g = proj[rt.clamp(0, h - 1)]
                    return torch.where(valid[..., None], g, 0.0) \
                        * wgt[..., None]

                gb = rtap(r0, 1.0 - fr) + rtap(r0 + 1, fr)
                acc += gb.permute(perm)
        else:
            zi, yi, xi = (grid(n, a, 3, device)
                          for a, n in enumerate(out_shape))
            for proj, mi in zip(projs, minvs):
                rr = [float(v) for v in mi[keep[0]]]
                cc = [float(v) for v in mi[keep[1]]]
                rows = rr[0] * zi + rr[1] * yi + rr[2] * xi + rr[3]
                cols = cc[0] * zi + cc[1] * yi + cc[2] * xi + cc[3]
                acc += _bilinear2d(proj, rows, cols)
        return acc

    return adjoint


def _validate(projections, matrices, out_shape, device, projection_axis):
    """Checked inputs on the device: (projections tensor, float32 numpy
    matrices, out_shape, axis, keep axes, inverse matrices)."""
    dev = _device(device)
    projs = _as_tensor(projections, dev).contiguous()
    matrices = np.asarray(matrices, np.float32)
    if projs.ndim != 3:
        raise ValueError("projections must be (N, H', W')")
    if matrices.shape != (projs.shape[0], 4, 4):
        raise ValueError("matrices must be (N, 4, 4) matching projections")
    out_shape = tuple(int(s) for s in out_shape)
    if len(out_shape) != 3:
        raise ValueError("out_shape must be 3-D")
    axis = _norm_axis(projection_axis)
    keep = [a for a in range(3) if a != axis]
    minv = np.stack([np.linalg.inv(m) for m in matrices]).astype(np.float32)
    return projs, matrices, out_shape, axis, keep, minv


def wbp_reconstruct(projections, matrices, out_shape,
                    projection_axis: int = 0,
                    filter_window: Optional[str] = "ramlak",
                    filter_axis="auto", device: str = "cuda",
                    output: Optional[str] = None):
    """Weighted back-projection from a tilt series.

    Parameters
    ----------
    projections : (N, H', W') stack (numpy or tensor), the output of
        :meth:`TiltSeriesProjector.project` or data in the same geometry.
    matrices : (N, 4, 4) pull-back matrices, the same ones the forward
        projection used (e.g. ``projector.tilt_matrices(angles)``).
    out_shape : (D, H, W) of the reconstructed volume.
    projection_axis : the axis the forward model integrated over.
    filter_window : 'ramlak', 'hamming', or None (plain back-projection).
    filter_axis : which projection axis (-2 rows / -1 cols) the ramp acts
        on, the one across the tilt axis.  'auto' detects it for single-axis
        tilt series: the projection axis whose coordinate map stays the
        identity in every matrix is the tilt axis; the other is filtered.
    device : 'cuda' (default), 'cuda:N' or 'cpu'.
    output : None -> host numpy; 'device' -> the tensor; a numpy array ->
        filled, returns None.

    Returns the (D, H, W) reconstruction scaled by ``pi / N`` (parallel-beam
    WBP over a [0, pi) sweep)."""
    projs, matrices, out_shape, axis, keep, minv = _validate(
        projections, matrices, out_shape, device, projection_axis)
    n_tilt = projs.shape[0]

    if filter_axis == "auto":
        # a projection axis whose coordinate map is the identity row in
        # every M^-1 is the tilt axis: filter the other one.  Ambiguous
        # geometries default to the minor axis.
        filter_axis = -1
        for pos, a in enumerate(keep):
            ident = np.zeros(4, np.float32)
            ident[a] = 1.0
            if np.abs(minv[:, a, :3] - ident[:3][None]).max() < 1e-5:
                filter_axis = -1 if pos == 0 else -2
                break
    if filter_axis not in (-1, -2):
        raise ValueError("filter_axis must be -1, -2, or 'auto'")

    adjoint = _make_adjoint(minv, keep, out_shape, tuple(projs.shape[1:]))
    if filter_window is not None:
        projs = ramp_filter(projs, axis=filter_axis, window=filter_window)
    # Riemann sum of the FBP integral over [0, pi): d_theta = pi / N
    result = adjoint(projs, minv) * (math.pi / n_tilt)
    return _result_out(result, output)


def sirt_reconstruct(projections, matrices, out_shape,
                     iterations: int = 30, relax: float = 1.0,
                     projection_axis: int = 0, nonneg: bool = False,
                     initial=None, device: str = "cuda",
                     output: Optional[str] = None,
                     _plain_forward: bool = False):
    """Simultaneous Iterative Reconstruction Technique (SIRT).

    Iterates ``x += relax * C A^T R (p - A x)``, where ``A`` is the
    tilt-series forward projector (rotate by each matrix with linear
    interpolation, sum over ``projection_axis``: the operator
    :class:`TiltSeriesProjector` applies, run through the planner's
    kernels) and ``A^T`` the back-projection; ``R`` and ``C`` are the
    inverse row and column sums (projections of ones and back-projections
    of ones), zero where a sum is at most 1e-6.  ``nonneg`` clips the
    iterate at 0 after each step; ``initial`` is the starting volume
    (zeros by default).  The iterate, like a resident volume, is pitched
    (:mod:`..kernels.layout`) and updated in place, so the forward sweep's
    slab kernel reads it with no copy; the result is contiguous.

    ``_plain_forward`` runs the forward operator through the kernels' plain
    version on the same device: the reference the kernel path is held
    against."""
    projs, matrices, out_shape, axis, keep, minv = _validate(
        projections, matrices, out_shape, device, projection_axis)
    dev = projs.device
    sweep = plain_project_stack if _plain_forward else project_stack

    def forward(vol):
        return sweep(vol, matrices, "linear", "constant", axis)

    adjoint = _make_adjoint(minv, keep, out_shape, tuple(projs.shape[1:]))
    eps = 1e-6
    row_sum = forward(pitched_empty(out_shape, device=dev).fill_(1.0))
    col_sum = adjoint(torch.ones_like(projs), minv)
    rinv = torch.where(row_sum > eps, 1.0 / row_sum, 0.0)
    cinv = torch.where(col_sum > eps, 1.0 / col_sum, 0.0)

    if initial is None:
        x = pitched_empty(out_shape, device=dev).zero_()
    else:
        x = pitched(_as_tensor(initial, dev), copy=True)
        if tuple(x.shape) != out_shape:
            raise ValueError(
                f"initial shape {tuple(x.shape)} does not match out_shape "
                f"{out_shape}")
    for _ in range(iterations):
        resid = (projs - forward(x)) * rinv
        x += relax * cinv * adjoint(resid, minv)
        if nonneg:   # projected SIRT: density is non-negative
            x.clamp_min_(0.0)
    return _result_out(x.contiguous(), output)

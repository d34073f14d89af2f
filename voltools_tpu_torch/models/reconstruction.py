"""Weighted back-projection and SIRT: the inverse of the tilt-series model.

The port's counterpart of ``voltools_tpu/models/reconstruction.py``.
:class:`~.projections.TiltSeriesProjector` computes ``p_m(y, x) = sum_z
vol(M (z, y, x))`` per tilt matrix ``M``.  The adjoint of (rotate by M, sum
over z) reads each projection at the (row, col) part of ``M^-1 w`` for every
output voxel ``w``: reconstruction ramp-filters each projection across the
tilt axis, back-projects it along the matching geometry, and sums.

The ramp filter is ``torch.fft`` along one projection axis; the
back-projection (the JAX package's ``lax.scan`` over tilts) is one launch
of the kernel C, :func:`~..kernels.backproject.backproject`, on the card,
and its plain version (a Python loop over tilts of a 2-D bilinear gather,
or of two whole-row gathers for a single-axis tilt series) on the CPU.
SIRT's forward operator is the projector's batched kernel sweep
(:func:`.projections.project_stack`), run once per iteration.

Given a :class:`~voltools_tpu_torch.parallel.Mesh`, both run over its
shards, as the JAX package's mesh modes do under ``shard_map``:
``wbp_reconstruct(mesh_shard='tilts')`` back-projects a share of the tilts
per shard and sums the partial volumes; ``mesh_shard='volume'`` and
``sirt_reconstruct(mesh=)`` give each shard a z slab of the volume.  The
volume-sharded SIRT forward sums per-slab partial projections (per-tap zero
extension), one launch of the kernel D2 a shard on the card
(:func:`~..kernels.partial_sample.partial_project`), where the JAX package
leaves it to XLA; its plain version over chunks of planes on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..kernels.backproject import backproject, plain_backproject, row_gather
from ..kernels.layout import pitched, pitched_empty
from ..kernels.partial_sample import (  # noqa: F401 (re-exported)
    _trilinear3d_pertap, partial_project, plain_partial_project)
from ..parallel.sharded import _crop, _host, _psum, _ring_shift, _shifted
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


def _mesh_out(slabs, d0: int, output):
    """The output contract for a z-sharded result: the per-shard slabs
    cropped to ``d0`` planes; 'device' returns them as a tuple (each on its
    shard's device), None and a numpy buffer as :func:`_result_out`."""
    slabs = _crop(slabs, d0)
    if isinstance(output, str):
        if output == "device":
            return slabs
        raise ValueError(
            f"output must be None, 'device', or a numpy array to fill, "
            f"got {output!r}")
    return _finish(_host(slabs), output)


def _make_adjoint(minv, keep, out_shape, proj_shape,
                  _force_general: bool = False, _plain: bool = False):
    """The back-projection ``(projs, minvs) -> volume`` shared by WBP and
    SIRT; ``projs`` is an (N, H', W') tensor, ``minvs`` the (N, 4, 4) numpy
    inverse matrices (column 3 may carry a shard's slab offset).

    The path is decided here, once, from ``minv`` (:func:`row_gather`: a
    single-axis tilt series takes the row-gather path, other geometries the
    general 2-D bilinear gather; ``_force_general`` the general path
    always).  Each call is one launch of the kernel C for CUDA projections,
    its plain version for CPU ones; ``_plain`` runs the plain version on
    any device, the reference the kernel is held against."""
    rowgather = row_gather(minv, keep, out_shape, proj_shape, _force_general)
    run = plain_backproject if _plain else backproject

    def adjoint(projs, minvs):
        return run(projs.contiguous(), minvs, keep, out_shape, rowgather)

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
                    filter_axis="auto", mesh=None, mesh_shard: str = "tilts",
                    device: str = "cuda", output: Optional[str] = None,
                    _plain_adjoint: bool = False):
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
    mesh : an optional :class:`~voltools_tpu_torch.parallel.Mesh`
        (``reconstruction.py:297-366``).  With ``mesh_shard='tilts'`` (the
        default) each shard back-projects its share of the tilts
        (zero-padded to divide the mesh) and the partial volumes are
        summed.  With ``mesh_shard='volume'`` each shard reconstructs its z
        slab of the volume from the replicated projections, the slab
        offset folded into ``M^-1``'s column 3, so the whole volume never
        lies on one device.  ``device`` is then ignored.
    device : 'cuda' (default), 'cuda:N' or 'cpu'.
    output : None -> host numpy; 'device' -> the tensor (with
        ``mesh_shard='volume'``, the tuple of per-shard slabs in z order);
        a numpy array -> filled, returns None.

    Returns the (D, H, W) reconstruction scaled by ``pi / N`` (parallel-beam
    WBP over a [0, pi) sweep).

    ``_plain_adjoint`` runs the back-projection through the kernel's plain
    version on the same device: the reference the kernel path is held
    against."""
    if mesh is not None:
        if mesh_shard not in ("tilts", "volume"):
            raise ValueError("mesh_shard must be 'tilts' or 'volume'")
        device = str(mesh.devices[0])
    projs, matrices, out_shape, axis, keep, minv = _validate(
        projections, matrices, out_shape, device, projection_axis)
    n_tilt = projs.shape[0]
    proj_shape = tuple(projs.shape[1:])

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

    def filtered(p):
        if filter_window is None:
            return p
        return ramp_filter(p, axis=filter_axis, window=filter_window)

    # Riemann sum of the FBP integral over [0, pi): d_theta = pi / N
    scale = math.pi / n_tilt
    if mesh is None:
        adjoint = _make_adjoint(minv, keep, out_shape, proj_shape,
                                _plain=_plain_adjoint)
        return _result_out(adjoint(filtered(projs), minv) * scale, output)
    if mesh_shard == "volume":
        # each shard its z slab of the output, from the replicated
        # (small) projections
        nd = mesh.size
        local = -(-out_shape[0] // nd)
        adjoint_s = _make_adjoint(minv, keep, (local,) + out_shape[1:],
                                  proj_shape, _plain=_plain_adjoint)
        projs = filtered(projs)
        replicas = {d: _ring_shift(projs, d) for d in mesh.distinct}
        slabs = [adjoint_s(replicas[d], _shifted(minv, np.float32(i * local)))
                 * scale for i, d in enumerate(mesh.devices)]
        return _mesh_out(slabs, out_shape[0], output)
    # each shard a share of the tilts: zero projections pad the batch to
    # divide the mesh (they add nothing; the scale counts the true tilts)
    adjoint = _make_adjoint(minv, keep, out_shape, proj_shape,
                            _plain=_plain_adjoint)
    nd = mesh.size
    padn = (-n_tilt) % nd
    if padn:
        projs = torch.cat([projs, projs.new_zeros((padn,) + proj_shape)])
        minv = np.concatenate(
            [minv, np.repeat(np.eye(4, dtype=np.float32)[None], padn, 0)])
    per = (n_tilt + padn) // nd
    partials = [adjoint(filtered(_ring_shift(projs[i * per:(i + 1) * per],
                                             d)),
                        minv[i * per:(i + 1) * per]) * scale
                for i, d in enumerate(mesh.devices)]
    first = mesh.devices[0]
    return _result_out(_psum(partials, [first])[first], output)


def sirt_reconstruct(projections, matrices, out_shape,
                     iterations: int = 30, relax: float = 1.0,
                     projection_axis: int = 0, nonneg: bool = False,
                     initial=None, device: str = "cuda",
                     output: Optional[str] = None, mesh=None,
                     _plain_forward: bool = False,
                     _plain_adjoint: bool = False):
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

    ``mesh``: an optional :class:`~voltools_tpu_torch.parallel.Mesh`,
    volume-sharded SIRT (:func:`_sirt_mesh`): each shard holds a z slab of
    the iterate, the normalisers and the adjoint's accumulator; ``device``
    is then ignored, and ``output='device'`` returns the tuple of per-shard
    slabs in z order.

    ``_plain_forward`` runs the forward operator through the kernels' plain
    version on the same device (with ``mesh``, the kernel D2's), and
    ``_plain_adjoint`` the back-projection through the kernel C's: the
    references the kernel path is held against."""
    if mesh is not None:
        device = str(mesh.devices[0])
    projs, matrices, out_shape, axis, keep, minv = _validate(
        projections, matrices, out_shape, device, projection_axis)
    if initial is not None:
        initial = _as_tensor(initial, projs.device)
        if tuple(initial.shape) != out_shape:
            raise ValueError(
                f"initial shape {tuple(initial.shape)} does not match "
                f"out_shape {out_shape}")
    if mesh is not None:
        return _sirt_mesh(projs, matrices, minv, out_shape, iterations,
                          relax, axis, nonneg, initial, mesh, output,
                          _plain_forward, _plain_adjoint)
    dev = projs.device
    sweep = plain_project_stack if _plain_forward else project_stack

    def forward(vol):
        return sweep(vol, matrices, "linear", "constant", axis)

    adjoint = _make_adjoint(minv, keep, out_shape, tuple(projs.shape[1:]),
                            _plain=_plain_adjoint)
    eps = 1e-6
    row_sum = forward(pitched_empty(out_shape, device=dev).fill_(1.0))
    col_sum = adjoint(torch.ones_like(projs), minv)
    rinv = torch.where(row_sum > eps, 1.0 / row_sum, 0.0)
    cinv = torch.where(col_sum > eps, 1.0 / col_sum, 0.0)

    if initial is None:
        x = pitched_empty(out_shape, device=dev).zero_()
    else:
        x = pitched(initial, copy=True)
    for _ in range(iterations):
        resid = (projs - forward(x)) * rinv
        x += relax * cinv * adjoint(resid, minv)
        if nonneg:   # projected SIRT: density is non-negative
            x.clamp_min_(0.0)
    return _result_out(x.contiguous(), output)


# the volume-sharded forward's step before the kernel D took it, by its old
# name: the plain version on the CPU, a launch of D2 on the card
_forward_partial = partial_project


def _sirt_mesh(projs, matrices, minv, out_shape, iterations, relax,
               projection_axis, nonneg, initial, mesh, output,
               _plain_forward=False, _plain_adjoint=False):
    """Volume-sharded SIRT: a z slab of the volume per shard
    (``reconstruction.py:491-598``).  Exact, not approximate:

    * **Forward** ``A x``: a trilinear sample is linear in the volume under
      per-tap zero extension, so each shard projects its own slab
      (:func:`~..kernels.partial_sample.partial_project`, one launch of
      D2, on its line path where the tilts leave the rays' second axis
      alone, as a single-axis series about an axis of the projection
      plane does) and the partial projections are summed
      over the shards (``psum``); a z tap across a slab boundary is split
      between its two owners with its exact weights.
    * **Adjoint** ``A^T r``: each shard back-projects the (replicated,
      small) residual into its slab, the slab offset folded into
      ``M^-1``'s column 3, as WBP's ``mesh_shard='volume'``.
    * The iterate, the normalisers and the accumulators live sharded; only
      projection-sized tensors are replicated, once per distinct device."""
    keep = [a for a in range(3) if a != projection_axis]
    n_tilt = projs.shape[0]
    proj_shape = tuple(projs.shape[1:])
    nd = mesh.size
    D = out_shape[0]
    local = -(-D // nd)
    slab = (local,) + out_shape[1:]
    adjoint_s = _make_adjoint(minv, keep, slab, proj_shape,
                              _plain=_plain_adjoint)
    devices, distinct = mesh.devices, mesh.distinct
    offs = [np.float32(i * local) for i in range(nd)]
    mvs = [_shifted(minv, off) for off in offs]

    project = plain_partial_project if _plain_forward else partial_project

    def forward(xs):
        """{device: A x}, the partials summed over the shards."""
        return _psum([project(x, matrices, float(off), out_shape,
                              projection_axis)
                      for x, off in zip(xs, offs)], devices)

    eps = 1e-6
    row_sum = forward([torch.ones(slab, device=d) for d in devices])
    rinv = {d: torch.where(r > eps, 1.0 / r, 0.0)
            for d, r in row_sum.items()}
    projs_on = {d: _ring_shift(projs, d) for d in distinct}
    cinv = []
    for d, mv in zip(devices, mvs):
        col_sum = adjoint_s(torch.ones((n_tilt,) + proj_shape, device=d), mv)
        cinv.append(torch.where(col_sum > eps, 1.0 / col_sum, 0.0))
    x0 = torch.zeros((local * nd,) + out_shape[1:], dtype=torch.float32,
                     device=devices[0])
    if initial is not None:
        x0[:D] = initial
    xs = [x0[i * local:(i + 1) * local].to(d, copy=True)
          for i, d in enumerate(devices)]
    for _ in range(iterations):
        fwd = forward(xs)
        resid = {d: (projs_on[d] - fwd[d]) * rinv[d] for d in distinct}
        for i, d in enumerate(devices):
            xs[i] = xs[i] + relax * cinv[i] * adjoint_s(resid[d], mvs[i])
            if nonneg:   # projected SIRT: density is non-negative
                xs[i] = torch.clamp_min(xs[i], 0.0)
    return _mesh_out(xs, D, output)

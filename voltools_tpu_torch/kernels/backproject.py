"""The back-projection kernel C: CUDA for CUDA tensors, plain torch on the CPU.

:func:`backproject` computes the adjoint of WBP and SIRT: for every output
voxel ``w`` the sum over tilts, in order, of a bilinear sample of each
projection at the (rows, cols) = the ``keep`` rows of ``M^-1 w``; a tap
outside the projection counts 0.  No TPU kernel stands behind it: the JAX
package leaves this loop to XLA (``lax.scan`` in
``voltools_tpu/models/reconstruction.py::_make_adjoint``).  For CUDA
projections it launches ``csrc/backproject.cu`` (built by ``nvcc`` at
first use, see :mod:`._build`) on the current stream without
synchronising; for CPU projections it runs the kernel's plain version,
:func:`plain_backproject`.  A CUDA tensor never falls back to the plain
version: the launch succeeds or the call raises.

Both take one of two paths, chosen by :func:`row_gather`: the row-gather
path for a single-axis tilt series (cols the identity coordinate of one
output axis, rows independent of it: a 1-D lerp across rows), and the
general path (a 2-D bilinear sample with 4 taps).  The kernel rounds every
operation as the plain version does, in its order, and equals it bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

NAME = "backproject"
SOURCE = "voltools_tpu_torch/csrc/backproject.cu"
REPLACES = "voltools_tpu/models/reconstruction.py:105"

# backproject_launch's parameters
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # projections
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,    # coefficients, path, ax_c
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # output
    ctypes.c_void_p,                                            # stream
]


@functools.lru_cache(maxsize=1)
def _library():
    lib = _build.load(NAME)
    fn = lib.backproject_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    lib.backproject_error_string.argtypes = [ctypes.c_int]
    lib.backproject_error_string.restype = ctypes.c_char_p
    return lib


def row_gather(minv, keep, out_shape, proj_shape,
               _force_general: bool = False) -> bool:
    """Whether the back-projection of ``minv`` ((N, 4, 4) inverse matrices)
    takes the row-gather path: cols is the identity coordinate of output
    axis ``keep[1]``, rows does not depend on it, and the projections are
    as wide as the output along it (every ``tilt_matrices`` stack).
    ``_force_general`` takes the general path whatever the geometry."""
    minv = np.asarray(minv, np.float32)
    ax_c = keep[1]
    ident = np.zeros(4, np.float32)
    ident[ax_c] = 1.0
    return bool(not _force_general
                and np.abs(minv[:, ax_c, :] - ident).max() < 1e-6
                and np.abs(minv[:, keep[0], ax_c]).max() < 1e-6
                and out_shape[ax_c] == proj_shape[1])


def coefficients(minv, keep, rowgather: bool) -> np.ndarray:
    """The kernel's per-tilt coefficients, float32, from the float32
    inverse matrices: row-gather (N, 4) rows ``(r_dep0, r_dep1, r3, 0)`` of
    row ``keep[0]`` (dep0 < dep1 the two axes other than ``keep[1]``);
    general (N, 8), row ``keep[0]`` then row ``keep[1]``."""
    minv = np.asarray(minv, np.float32)
    if rowgather:
        dep = [a for a in range(3) if a != keep[1]]
        r = minv[:, keep[0]]
        return np.ascontiguousarray(np.stack(
            [r[:, dep[0]], r[:, dep[1]], r[:, 3], np.zeros_like(r[:, 3])],
            axis=1))
    return np.ascontiguousarray(minv[:, list(keep), :].reshape(-1, 8))


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


def _grid(n, axis, ndim, device):
    view = [1] * ndim
    view[axis] = n
    return torch.arange(n, dtype=torch.float32, device=device).view(view)


def plain_backproject(projs, minv, keep, out_shape, rowgather=None):
    """The kernel's plain version: a Python loop over tilts.  Row-gather:
    two whole-row gathers of each projection, a lerp and a permute; general:
    the 2-D bilinear gather.  ``rowgather`` None decides by
    :func:`row_gather`."""
    out_shape = tuple(int(s) for s in out_shape)
    proj_shape = tuple(projs.shape[1:])
    if rowgather is None:
        rowgather = row_gather(minv, keep, out_shape, proj_shape)
    device = projs.device
    acc = torch.zeros(out_shape, dtype=torch.float32, device=device)
    if rowgather:
        ax_c = keep[1]
        dep = [a for a in range(3) if a != ax_c]
        perm = tuple(int(i) for i in np.argsort(dep + [ax_c]))
        i0 = _grid(out_shape[dep[0]], 0, 2, device)
        i1 = _grid(out_shape[dep[1]], 1, 2, device)
        h = proj_shape[0]
        for proj, mi in zip(projs, minv):
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
        zi, yi, xi = (_grid(n, a, 3, device) for a, n in enumerate(out_shape))
        for proj, mi in zip(projs, minv):
            rr = [float(v) for v in mi[keep[0]]]
            cc = [float(v) for v in mi[keep[1]]]
            rows = rr[0] * zi + rr[1] * yi + rr[2] * xi + rr[3]
            cols = cc[0] * zi + cc[1] * yi + cc[2] * xi + cc[3]
            acc += _bilinear2d(proj, rows, cols)
    return acc


def _check(projs, minv, keep, out_shape):
    """Validate the arguments; returns the float32 numpy matrices."""
    if not isinstance(projs, torch.Tensor):
        raise TypeError("projections must be a torch tensor")
    if projs.dtype != torch.float32:
        raise ValueError(f"projections must be float32, got {projs.dtype}")
    if projs.ndim != 3 or min(projs.shape) < 1:
        raise ValueError(
            f"projections must be a non-empty (N, H', W'), got "
            f"{tuple(projs.shape)}")
    if not projs.is_contiguous():
        raise ValueError("projections must be contiguous")
    minv = np.asarray(minv)
    if minv.dtype != np.float32:
        raise ValueError(f"matrices must be float32, got {minv.dtype}")
    if minv.shape != (projs.shape[0], 4, 4):
        raise ValueError(
            f"matrices must be (N, 4, 4) with N = {projs.shape[0]} "
            f"projections, got {minv.shape}")
    if len(keep) != 2 or not 0 <= keep[0] < keep[1] <= 2:
        raise ValueError(f"keep must be two axes in increasing order, "
                         f"got {keep!r}")
    if len(out_shape) != 3 or min(out_shape) < 1:
        raise ValueError(
            f"out_shape must be 3 positive extents, got {out_shape}")
    return minv


def backproject(projs: torch.Tensor, minv, keep, out_shape,
                rowgather=None) -> torch.Tensor:
    """Back-project ``projs`` (N, H', W') through ``minv`` ((N, 4, 4)
    float32 numpy inverse matrices, column 3 may carry a slab offset) into
    a new contiguous float32 ``out_shape`` tensor on the projections'
    device.  ``keep`` is the two axes of ``M^-1 w`` that index a projection
    (rows, cols), in increasing order.  ``rowgather`` picks the path (None:
    :func:`row_gather` of ``minv``).  ``backproject.launches`` counts the
    kernel launches (the CPU path launches nothing); each call launches
    once."""
    out_shape = tuple(int(s) for s in out_shape)
    keep = tuple(int(k) for k in keep)
    minv = _check(projs, minv, keep, out_shape)
    if rowgather is None:
        rowgather = row_gather(minv, keep, out_shape, tuple(projs.shape[1:]))
    elif rowgather and out_shape[keep[1]] != projs.shape[2]:
        raise ValueError(
            f"the row-gather path needs projections as wide as the output "
            f"along axis {keep[1]}: {projs.shape[2]} != "
            f"{out_shape[keep[1]]}")
    if projs.device.type == "cpu":
        return plain_backproject(projs, minv, keep, out_shape, rowgather)
    if projs.device.type != "cuda":
        raise ValueError(f"unsupported device {projs.device}")
    table = coefficients(minv, keep, rowgather)
    out = torch.empty(out_shape, dtype=torch.float32, device=projs.device)
    lib = _library()
    # the launch goes to the current device; make it the projections' for
    # the call only, so the caller's current device is left as it was
    with torch.cuda.device(projs.device):
        # the table goes up through pinned memory without blocking, in
        # stream order, so the call does not wait for the device
        coef = torch.from_numpy(table).pin_memory().to(projs.device,
                                                       non_blocking=True)
        code = lib.backproject_launch(
            projs.data_ptr(), *projs.shape, coef.data_ptr(),
            int(bool(rowgather)), keep[1], out.data_ptr(), *out_shape,
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        message = lib.backproject_error_string(code).decode()
        raise RuntimeError(f"backproject launch failed: {message} ({code})")
    backproject.launches += 1
    return out


backproject.launches = 0

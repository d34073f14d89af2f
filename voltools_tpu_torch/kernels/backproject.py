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

The kernel's row-gather path stages, for each tilt, the projection rows
that a CTA's tile of lines reads (its window) in shared memory.  The host
sizes the tile (:func:`rowgather_tile`): the first of :data:`TILES`
whose window, bounded from the rows span over the launch's tilts
(:func:`window_rows`), fits the dynamic shared memory.  The windows are
copied by TMA, which reads rows 16 bytes apart: 250-float rows go over as
a pitched copy (:func:`_tma_rows`).  A tap outside its
window is read from global memory and counted on the device
(:func:`window_misses`), so the result stays right; the count reads 0
wherever the bound holds.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import trace
from . import _build
from .affine_resample import _device_index
from .layout import padded_width, row_pitch, tma_ready

NAME = "backproject"
SOURCE = "voltools_tpu_torch/csrc/backproject.cu"
REPLACES = "voltools_tpu/models/reconstruction.py:105"

# backproject_launch's parameters
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # projections
    ctypes.c_int,                                   # their row pitch
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,    # coefficients, path, ax_c
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # output
    ctypes.c_int, ctypes.c_int, ctypes.c_int,       # tile: warps, lines, cap
    ctypes.c_int,                                   # its shared memory
    ctypes.c_void_p,                                # window-miss counter
    ctypes.c_void_p,                                # stream
]

# The row-gather kernel's layout, the one table of it: the build passes
# it to nvcc as -D flags, and the host sizes tiles and shared memory from
# it.  Column pairs a lane (a tile's columns are 64 times as many), most
# warps a CTA (one dep0 line each), lines a thread along dep1 in large
# tiles, the ring's stages, the rows a window may hold (TMA's largest box)
# and the bytes that align the windows for TMA.
LAYOUT = {"BP_PAIRS": 4, "BP_WARPS": 8, "BP_LINES": 8, "BP_STAGES": 2,
          "BP_MAX_CAP": 256, "BP_ALIGN": 128}
STAGES = LAYOUT["BP_STAGES"]
TILE_COLUMNS = 64 * LAYOUT["BP_PAIRS"]
MAX_CAP = LAYOUT["BP_MAX_CAP"]
# the dynamic shared memory a CTA may take on an H100 (227 KB less 1 KB for
# its static barriers)
SMEM_LIMIT = 232448 - 1024
# the row-gather tiles in the order the host tries them: (warps, one dep0
# line each; lines a thread along dep1).  The kernel is built for 1 and
# BP_LINES lines a thread.  4 x 8 first: on an H100 it beats 8 x 8 by 4%
# and 2 x 8 by 10% (tools/backproject_variants.py), and any window 8 x 8
# can hold, 4 x 8 can hold too; smaller tiles serve larger row spans
_W, _L = LAYOUT["BP_WARPS"], LAYOUT["BP_LINES"]
TILES = ((4, _L), (2, _L), (_W, 1), (1, _L), (4, 1), (2, 1), (1, 1))

# per CUDA device index: the kernel's int32 window-miss counter
_MISSES: dict = {}


class RowTile(NamedTuple):
    """A row-gather launch's tile: ``warps`` lines along dep0 by ``lines``
    along dep1, and ``cap`` rows a stage of its shared-memory ring."""
    warps: int
    lines: int
    cap: int


@functools.lru_cache(maxsize=1)
def _library():
    lib = _build.load(NAME, LAYOUT)
    fn = lib.backproject_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    lib.backproject_error_string.argtypes = [ctypes.c_int]
    lib.backproject_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(warps: int, lines: int, cap: int, layout=LAYOUT) -> int:
    """Dynamic shared memory of a row-gather CTA of ``layout``, the bytes
    the launch gives it: per stage a window of ``cap`` rows of the tile's
    columns and a line table (16 bytes a line), one row of zeros, and
    ``BP_ALIGN`` bytes to align the windows."""
    stages, columns = layout["BP_STAGES"], 64 * layout["BP_PAIRS"]
    return (layout["BP_ALIGN"] + 4 * (stages * cap + 1) * columns
            + 16 * stages * warps * lines)


def window_rows(table, warps: int, lines: int, n0: int, n1: int,
                h: int) -> int:
    """The most projection rows that a tile of ``warps`` x ``lines`` lines
    stages for one tilt, over the tilts of the row-gather ``table`` (N, 4),
    for an output of ``n0`` x ``n1`` lines and projections of ``h`` rows.

    A bound from the rows span: over the tile, the exact rows coordinate
    spans ``S = |r_dep0| (warps - 1) + |r_dep1| (lines - 1)``; each of its
    floats is within ``slack`` (four roundings of at most 2^-24 of the
    largest term, taken 4x over) of the exact value, so its corners' floors
    differ by at most ``floor(S + 2 slack) + 1`` and the window, which adds
    the row below the highest, holds at most ``floor(S + 2 slack) + 3``
    rows, and never more than ``h``.  A tilt whose rows lie off the
    projection over the whole output stages nothing."""
    t = np.asarray(table, np.float64)
    a, b, r3 = t[:, 0], t[:, 1], t[:, 2]
    slack = (np.abs(a) * (n0 - 1) + np.abs(b) * (n1 - 1) + np.abs(r3)
             + 1.0) * 2.0 ** -20
    low = r3 + np.minimum(a, 0) * (n0 - 1) + np.minimum(b, 0) * (n1 - 1)
    high = r3 + np.maximum(a, 0) * (n0 - 1) + np.maximum(b, 0) * (n1 - 1)
    # not (off below or off above): NaN coefficients count as meeting it
    meets = ~((high + slack < -1.0) | (low - slack >= h))
    span = (np.abs(a) * (min(warps, n0) - 1)
            + np.abs(b) * (min(lines, n1) - 1))
    rows = np.floor(span + 2.0 * slack) + 3.0
    rows = np.where(np.isfinite(rows), np.minimum(rows, h), h)[meets]
    return int(rows.max()) if rows.size else 0


def rowgather_tile(table, n0: int, n1: int, h: int) -> RowTile:
    """The row-gather launch's tile: the first of :data:`TILES` whose
    window (:func:`window_rows`) fits :data:`SMEM_LIMIT`; else the one-line
    tile with as many rows as fit (a window larger than that reads its
    other taps from global memory, counted by :func:`window_misses`)."""
    for warps, lines in TILES:
        cap = max(window_rows(table, warps, lines, n0, n1, h), 1)
        if cap <= MAX_CAP and smem_bytes(warps, lines, cap) <= SMEM_LIMIT:
            return RowTile(warps, lines, cap)
    fit = (SMEM_LIMIT - smem_bytes(1, 1, 0)) // (4 * STAGES * TILE_COLUMNS)
    return RowTile(1, 1, int(min(fit, MAX_CAP)))


def _tma_rows(projs: torch.Tensor) -> torch.Tensor:
    """``projs`` where TMA can read its rows (16 bytes apart, 16-byte
    aligned), else a copy with rows padded to a multiple of 4 floats (a
    250-float row is 1000 bytes: a pass over the projections, 10 MB at
    250^3).  TMA never reads the padding, so it is left unset."""
    if tma_ready(projs):
        return projs
    n, h, w = projs.shape
    out = torch.empty((n, h, padded_width(w)), dtype=projs.dtype,
                      device=projs.device)[..., :w]
    if trace.ON:
        trace.count("pitched_copies")
        trace.count("pitched_copy_bytes", out.untyped_storage().nbytes())
    with trace.device_work(projs):
        return out.copy_(projs)


def window_misses(device="cuda") -> int:
    """How many taps the row-gather kernel read outside its staged window
    on ``device``, in this process.  Reading it waits for the device."""
    counter = _MISSES.get(_device_index(device))
    return 0 if counter is None else int(counter.item())


def _miss_counter(device: torch.device) -> torch.Tensor:
    index = _device_index(device)
    counter = _MISSES.get(index)
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32,
                              device=torch.device("cuda", index))
        _MISSES[index] = counter
    return counter


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
    with trace.span("kernel_c.table"):
        table = coefficients(minv, keep, rowgather)
        tile = RowTile(0, 0, 0)   # the general path reads none
        if rowgather:
            dep1 = 1 if keep[1] == 2 else 2
            tile = rowgather_tile(table, out_shape[0], out_shape[dep1],
                                  projs.shape[1])
        # the table goes up through pinned memory without blocking, in
        # stream order, so the call does not wait for the device
        host = torch.from_numpy(table).pin_memory()
        if trace.ON:
            trace.count("upload_bytes", table.nbytes)
        with trace.device_work(projs):
            coef = host.to(projs.device, non_blocking=True)
    if rowgather:
        projs = _tma_rows(projs)
    out = torch.empty(out_shape, dtype=torch.float32, device=projs.device)
    lib = _library()
    # the launch goes to the current device; make it the projections' for
    # the call only, so the caller's current device is left as it was
    with torch.cuda.device(projs.device):
        code = lib.backproject_launch(
            projs.data_ptr(), *projs.shape, row_pitch(projs),
            coef.data_ptr(), int(bool(rowgather)), keep[1], out.data_ptr(),
            *out_shape, *tile, smem_bytes(*tile),
            _miss_counter(projs.device).data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        message = lib.backproject_error_string(code).decode()
        raise RuntimeError(f"backproject launch failed: {message} ({code})")
    backproject.launches += 1
    return out


backproject.launches = 0

"""The per-slab partial sample, kernel D: CUDA for CUDA tensors, plain torch
on the CPU.

Two functions of the sharded paths, where the JAX package leaves the work
to XLA, each a sum of per-tap zero-extended samples of one z slab of a
volume (the partials of disjoint slabs sum to the whole volume's sample):

* D1, :class:`ShardedVolume`'s ring stream
  (``voltools_tpu/parallel/sharded.py::_partial_sample_pertap``), two
  entries: :func:`partial_sample_ring`, a shard's whole ring in one launch
  (every slab of the ring on the shard's device), and
  :func:`partial_sample`, one step of it, which adds one source slab's
  partial sample into a shard's accumulator and on the ring's last step
  applies the whole-sample inside test with ``cval``.  Their plain
  version is the chain of :func:`plain_partial_step` calls, over
  :func:`plain_partial_sample` at the coordinates of :func:`sample_frame`
  (:func:`plain_partial_ring` for a whole ring); both kernels equal it bit
  for bit.
* :func:`partial_project` (D2), a shard's part of the volume-sharded SIRT
  forward (``voltools_tpu/models/reconstruction.py::_sirt_mesh``): per
  tilt, the sum over the projection axis of the slab's per-tap samples,
  masked by the global inside test.  Its plain version is
  :func:`plain_partial_project`; the kernel sums the planes in order, as
  the JAX package's ``fori_loop`` does, the plain version in chunks with
  ``torch.sum``, so the two agree within the error of a float32 sum
  (:func:`sum_order_atol`).  Where :func:`line_axis` finds the rays'
  second axis untouched by every matrix (tilt series about an axis of
  the projection plane), the kernel's line path forms each line's
  coordinates once for all its rays and reads 4 taps a sample in place
  of 8, equal to the general kernel bit for bit on a finite slab.

For CUDA tensors each launches ``csrc/partial_sample.cu`` (built by
``nvcc`` at first use, see :mod:`._build`) on the current stream without
synchronising; for CPU tensors it runs the plain version.  A CUDA tensor
never falls back to the plain version: the launch succeeds or the call
raises.  ``_build.launches()`` counts the launches under
``"partial_sample"``, ``"partial_sample_ring"`` and ``"partial_project"``,
those of D2 on the line path under ``"partial_project.line"`` too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.interpolation import (_inside, _mirror_index,
                                 cubic_bspline_weights, spline_order)
from ..ops.sampling import affine_coords
from . import _build
from .planner import _leaves_alone

NAME = "partial_sample"
SOURCE = "voltools_tpu_torch/csrc/partial_sample.cu"
REPLACES = {"partial_sample": "voltools_tpu/parallel/sharded.py:119",
            "partial_project": "voltools_tpu/models/reconstruction.py:535"}

_MODES = {"constant": 0, "border": 1}
_INTERPOLATION = {1: "linear", 3: "bspline"}

# partial_sample_launch's parameters
SAMPLE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,    # slab, planes, first
    ctypes.c_int, ctypes.c_int, ctypes.c_int,       # the true extent
    ctypes.c_void_p,                                # matrix (host)
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # acc
    ctypes.c_int, ctypes.c_int, ctypes.c_int,       # order, border, last
    ctypes.c_float,                                 # cval
    ctypes.c_void_p,                                # stream
]
# partial_sample_ring_launch's parameters
RING_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # slabs, firsts, count
    ctypes.c_int,                                   # planes a slab
    ctypes.c_int, ctypes.c_int, ctypes.c_int,       # the true extent
    ctypes.c_void_p,                                # matrix (host)
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # out
    ctypes.c_int, ctypes.c_int,                     # order, border
    ctypes.c_float,                                 # cval
    ctypes.c_void_p,                                # stream
]
# partial_project_launch's parameters
PROJECT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # slab
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float,  # rows, tilts, offset
    ctypes.c_int, ctypes.c_int, ctypes.c_int,       # the global shape
    ctypes.c_int,                                   # projection axis
    ctypes.c_int,                                   # line axis, or 0
    ctypes.c_void_p,                                # out
    ctypes.c_void_p,                                # stream
]
# the most slabs a ring launch takes (the kernel's kMaxRing)
RING_CAPACITY = 32

# output voxels of the plain projection's coordinates per chunk of planes
_FORWARD_CHUNK_VOXELS = 1 << 22


LIBRARY = _build.Library(NAME, {"partial_sample_launch": SAMPLE_ARGTYPES,
                                "partial_sample_ring_launch": RING_ARGTYPES,
                                "partial_project_launch": PROJECT_ARGTYPES})
_SAMPLE = LIBRARY.launcher("partial_sample_launch", "partial_sample")
_RING = LIBRARY.launcher("partial_sample_ring_launch", "partial_sample_ring")
_PROJECT = LIBRARY.launcher("partial_project_launch", "partial_project")
_PROJECT_LINE = LIBRARY.launcher("partial_project_launch", "partial_project",
                                 "partial_project.line")


# ------------------------------------------------------------------ D1

def plain_partial_sample(slab, coords, z0: int, true_shape,
                         interpolation: str, mode: str) -> torch.Tensor:
    """This z-slab's contribution to a whole-volume interpolation sample
    (``voltools_tpu/parallel/sharded.py:119-205``).

    ``slab`` holds source planes ``[z0, z0 + slab.shape[0])`` of a volume
    whose TRUE extent is ``true_shape``; ``coords`` are GLOBAL fractional
    source coordinates.  Tap indices resolve as the single-device sampler's
    do (clip for linear 'constant', mirror for cubic 'constant', zero
    outside for 'border'); each tap then counts only where its z index
    lands in this slab: per-tap zero extension, under which the sample is
    linear in the source over disjoint slabs, so the partials of all slabs
    sum to the full sample.  The whole-sample inside/cval mask is the
    caller's (it needs global coordinates only)."""
    d0, d1, d2 = true_shape
    loc = slab.shape[0]
    flat = slab.reshape(-1)
    sz, sy, sx = coords[0], coords[1], coords[2]
    z0f, y0f, x0f = torch.floor(sz), torch.floor(sy), torch.floor(sx)
    zb = z0f.to(torch.int64)
    yb = y0f.to(torch.int64)
    xb = x0f.to(torch.int64)
    fz, fy, fx = sz - z0f, sy - y0f, sx - x0f
    constant = mode == "constant"

    def tap(zg, yg, xg, ok, w):
        zl = zg - z0
        own = (zl >= 0) & (zl < loc)
        if ok is not None:
            own = own & ok
        lin = (zl.clamp(0, loc - 1) * d1 + yg.clamp(0, d1 - 1)) * d2 \
            + xg.clamp(0, d2 - 1)
        return torch.where(own, torch.take(flat, lin), 0.0) * w

    out = torch.zeros_like(sz)
    if spline_order(interpolation) == 1:
        for dz in (0, 1):
            wz = fz if dz else 1.0 - fz
            for dy in (0, 1):
                wy = fy if dy else 1.0 - fy
                for dx in (0, 1):
                    wx = fx if dx else 1.0 - fx
                    z, y, x = zb + dz, yb + dy, xb + dx
                    # single-device semantics: 'constant' taps clip (an
                    # in-range point's +1 tap only clips with weight 0)
                    ok = None if constant else (
                        (z >= 0) & (z < d0) & (y >= 0) & (y < d1)
                        & (x >= 0) & (x < d2))
                    out = out + tap(z.clamp(0, d0 - 1), y, x, ok,
                                    wz * wy * wx)
        return out

    wzs = cubic_bspline_weights(fz)
    wys = cubic_bspline_weights(fy)
    wxs = cubic_bspline_weights(fx)

    def cidx(base, t, n):
        idx = base + (t - 1)
        if constant:   # scipy: taps mirror-reflect at the global edges
            return _mirror_index(idx, n), None
        return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)

    for dz in range(4):
        z, okz = cidx(zb, dz, d0)
        for dy in range(4):
            y, oky = cidx(yb, dy, d1)
            w_zy = wzs[dz] * wys[dy]
            for dx in range(4):
                x, okx = cidx(xb, dx, d2)
                ok = None if constant else (okz & oky & okx)
                out = out + tap(z, y, x, ok, w_zy * wxs[dx])
    return out


def sample_frame(matrix, out_shape, true_shape, mode: str, device):
    """The global source coordinates of an output slab of ``out_shape``
    through ``matrix`` ((4, 4) float32, its slab shift in column 3) and
    their inside test by ``mode`` against ``true_shape``: what every plain
    step of one shard shares."""
    coords = affine_coords(tuple(out_shape),
                           torch.from_numpy(np.asarray(matrix, np.float32)),
                           device=device)
    return coords, _inside(coords[0], coords[1], coords[2], true_shape, mode)


def plain_partial_step(slab, coords, inside, z0: int, true_shape,
                       order: int, mode: str, acc, last: bool = False,
                       cval: float = 0.0) -> torch.Tensor:
    """:func:`partial_sample`'s plain version, on ``acc``'s device, at the
    coordinates and inside test of :func:`sample_frame`: the slab's
    :func:`plain_partial_sample` added into ``acc`` where ``inside``, and
    with ``last`` ``cval`` written everywhere else.  Returns ``acc``."""
    part = plain_partial_sample(slab, coords, z0, true_shape,
                                _INTERPOLATION[order], mode)
    # acc + 0.0 is acc: the voxels outside keep their value until the last
    # step, as the kernel leaves them
    acc.add_(torch.where(inside, part, 0.0))
    if last:
        acc.masked_fill_(~inside, cval)
    return acc


def _check_step(slabs, acc, matrix, true_shape, order: int, mode: str):
    """D1's argument checks: ``slabs`` float32 contiguous 3-D tensors of
    one shape on one device that hold planes of a volume of
    ``true_shape``; ``acc`` (unless None) likewise a float32 contiguous
    3-D tensor on their device; ``matrix`` (4, 4) float32.  Returns
    ``true_shape`` as a tuple of ints and ``matrix`` as a numpy array."""
    true_shape = tuple(int(s) for s in true_shape)
    matrix = np.asarray(matrix)
    tensors = slabs if acc is None else (*slabs, acc)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("slab and acc must be torch tensors")
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"slab and acc must be float32, got {t.dtype}")
        if t.ndim != 3 or min(t.shape) < 1:
            raise ValueError(f"slab and acc must be non-empty 3-D tensors, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("slab and acc must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError(f"slab and acc on {t.device} and "
                             f"{tensors[0].device}")
    for slab in slabs:
        if len(true_shape) != 3 or tuple(slab.shape[1:]) != true_shape[1:]:
            raise ValueError(f"the slab {tuple(slab.shape)} does not hold "
                             f"planes of a volume of shape {true_shape}")
        if slab.shape != slabs[0].shape:
            raise ValueError(f"the ring's slabs differ in shape: "
                             f"{[tuple(t.shape) for t in slabs]}")
    if matrix.dtype != np.float32 or matrix.shape != (4, 4):
        raise ValueError(f"matrix must be a (4, 4) float32 array, got "
                         f"{matrix.dtype} {matrix.shape}")
    if order not in _INTERPOLATION:
        raise ValueError(f"order must be 1 or 3, got {order!r}")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}, got {mode!r}")
    return true_shape, matrix


def partial_sample(slab: torch.Tensor, matrix, z0: int, true_shape,
                   order: int, mode: str, acc: torch.Tensor,
                   last: bool = False, cval: float = 0.0) -> torch.Tensor:
    """Add the partial sample of ``slab`` (contiguous float32, global
    planes ``[z0, z0 + slab.shape[0])`` of a volume of TRUE extent
    ``true_shape``, whose rows and columns it shares) into ``acc`` (a
    contiguous float32 output slab on the slab's device), in place, through
    the pull-back ``matrix`` ((4, 4) float32 numpy: the output slab's, its
    slab shift in column 3), ``order`` 1 or 3, ``mode`` 'constant' or
    'border'.  Only voxels whose source point lies inside the volume by
    ``mode``'s test take a sample; with ``last`` (the ring's last step) the
    others are set to ``cval``.  Returns ``acc``.  Each CUDA call is one
    launch, counted as ``"partial_sample"``."""
    true_shape, matrix = _check_step((slab,), acc, matrix, true_shape, order,
                                     mode)
    if slab.device.type == "cpu":
        coords, inside = sample_frame(matrix, acc.shape, true_shape, mode,
                                      acc.device)
        return plain_partial_step(slab, coords, inside, z0, true_shape,
                                  order, mode, acc, last, cval)
    if slab.device.type != "cuda":
        raise ValueError(f"unsupported device {slab.device}")
    rows = np.ascontiguousarray(matrix[:3])
    _SAMPLE(slab.device,
            slab.data_ptr(), slab.shape[0], int(z0), *true_shape,
            rows.ctypes.data, acc.data_ptr(), *acc.shape, order,
            _MODES[mode], int(bool(last)), float(cval))
    return acc


def plain_partial_ring(slabs, z0s, matrix, true_shape, order: int, mode: str,
                       out_shape, cval: float = 0.0) -> torch.Tensor:
    """:func:`partial_sample_ring`'s plain version, on the slabs' device:
    a zero accumulator of ``out_shape`` and one :func:`plain_partial_step`
    for each slab in the given order, the last with ``cval``, at the
    coordinates and inside test of :func:`sample_frame` formed once."""
    device = slabs[0].device
    acc = torch.zeros(tuple(out_shape), dtype=torch.float32, device=device)
    frame = sample_frame(matrix, acc.shape, true_shape, mode, device)
    for k, (slab, z0) in enumerate(zip(slabs, z0s)):
        plain_partial_step(slab, *frame, int(z0), true_shape, order, mode,
                           acc, k == len(slabs) - 1, cval)
    return acc


def partial_sample_ring(slabs, z0s, matrix, true_shape, order: int,
                        mode: str, out_shape,
                        cval: float = 0.0) -> torch.Tensor:
    """A shard's whole ring stream in one call: the output slab of
    ``out_shape`` (a new contiguous float32 tensor on the slabs' device)
    resampled through ``matrix`` from ``slabs``, the shard's source slabs
    in ring order (contiguous float32 tensors of one shape on one device,
    slab ``k`` holding global planes ``[z0s[k], z0s[k] + planes)`` of a
    volume of TRUE extent ``true_shape``), ``order``, ``mode`` and
    ``cval`` as for :func:`partial_sample`.  Equal, bit for bit, to the
    chain of :func:`partial_sample` steps over the same slabs in the same
    order from a zero accumulator, the last with ``last=True``
    (:func:`plain_partial_ring`).  On the card one launch, counted as
    ``"partial_sample_ring"``; it takes at most ``RING_CAPACITY``
    slabs."""
    slabs = tuple(slabs)
    z0s = [int(z) for z in z0s]
    out_shape = tuple(int(s) for s in out_shape)
    if not slabs or len(z0s) != len(slabs):
        raise ValueError(f"a ring needs at least one slab and a first plane "
                         f"for each, got {len(slabs)} slabs and "
                         f"{len(z0s)} planes")
    if len(out_shape) != 3 or min(out_shape) < 1:
        raise ValueError(f"out_shape must be 3 positive extents, got "
                         f"{out_shape}")
    true_shape, matrix = _check_step(slabs, None, matrix, true_shape, order,
                                     mode)
    device = slabs[0].device
    if device.type == "cpu":
        return plain_partial_ring(slabs, z0s, matrix, true_shape, order,
                                  mode, out_shape, cval)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if len(slabs) > RING_CAPACITY:
        raise ValueError(f"a ring launch takes at most {RING_CAPACITY} "
                         f"slabs, got {len(slabs)}")
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    rows = np.ascontiguousarray(matrix[:3])
    pointers = (ctypes.c_void_p * len(slabs))(*(t.data_ptr() for t in slabs))
    firsts = (ctypes.c_int * len(slabs))(*z0s)
    _RING(device,
          pointers, firsts, len(slabs), slabs[0].shape[0], *true_shape,
          rows.ctypes.data, out.data_ptr(), *out_shape, order,
          _MODES[mode], float(cval))
    return out


# ------------------------------------------------------------------ D2

def _trilinear3d_pertap(vol, zz, yy, xx):
    """Trilinear sample of a 3-D block at float coordinate tensors with
    PER-TAP zero extension: each of the 8 taps contributes 0 outside the
    block (``voltools_tpu/models/reconstruction.py:148-183``).  Unlike the
    scipy 'constant' whole-sample mask this is linear in ``vol`` under zero
    extension: the samples of disjoint z slabs sum to the sample of the
    whole volume (the caller applies the whole-sample mask from global
    coordinates)."""
    l, h, w = vol.shape
    flat = vol.reshape(-1)
    z0f = torch.floor(zz)
    y0f = torch.floor(yy)
    x0f = torch.floor(xx)
    fz = zz - z0f
    fy = yy - y0f
    fx = xx - x0f
    z0 = z0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)

    def tap(zt, yt, xt, wgt):
        valid = ((zt >= 0) & (zt < l) & (yt >= 0) & (yt < h)
                 & (xt >= 0) & (xt < w))
        v = torch.take(flat, (zt.clamp(0, l - 1) * h + yt.clamp(0, h - 1))
                       * w + xt.clamp(0, w - 1))
        return torch.where(valid, v, 0.0) * wgt

    return (tap(z0, y0, x0, (1 - fz) * (1 - fy) * (1 - fx))
            + tap(z0, y0, x0 + 1, (1 - fz) * (1 - fy) * fx)
            + tap(z0, y0 + 1, x0, (1 - fz) * fy * (1 - fx))
            + tap(z0, y0 + 1, x0 + 1, (1 - fz) * fy * fx)
            + tap(z0 + 1, y0, x0, fz * (1 - fy) * (1 - fx))
            + tap(z0 + 1, y0, x0 + 1, fz * (1 - fy) * fx)
            + tap(z0 + 1, y0 + 1, x0, fz * fy * (1 - fx))
            + tap(z0 + 1, y0 + 1, x0 + 1, fz * fy * fx))


def plain_partial_project(x_slab, matrices, off: float, out_shape,
                          projection_axis: int) -> torch.Tensor:
    """This slab's contribution to the forward projections, (N, A, B): per
    tilt, the sum over the projection axis of per-tap samples of the
    zero-extended slab (its first plane at global z ``off``), masked by the
    global scipy 'constant' inside test
    (``voltools_tpu/models/reconstruction.py:535-556``).  The JAX package
    loops over planes; here a tilt's planes go in chunks of at most
    ``_FORWARD_CHUNK_VOXELS`` coordinates, each summed by ``torch.sum``,
    and a chunk whose source z range lies off the slab by more than a
    voxel is skipped: each of its taps would count 0."""
    keep = [a for a in range(3) if a != projection_axis]
    n_a, n_b = out_shape[keep[0]], out_shape[keep[1]]
    n_p = out_shape[projection_axis]
    dev = x_slab.device
    local = x_slab.shape[0]
    chunk = max(1, _FORWARD_CHUNK_VOXELS // (n_a * n_b))
    grids = {keep[0]: torch.arange(n_a, dtype=torch.float32,
                                   device=dev).view(1, n_a, 1),
             keep[1]: torch.arange(n_b, dtype=torch.float32,
                                   device=dev).view(1, 1, n_b)}
    planes = torch.arange(n_p, dtype=torch.float32, device=dev).view(
        n_p, 1, 1)
    result = torch.zeros((len(matrices), n_a, n_b), dtype=torch.float32,
                         device=dev)
    for n, m in enumerate(matrices):
        rows = [[float(v) for v in m[r]] for r in range(3)]
        for t0 in range(0, n_p, chunk):
            t1 = min(t0 + chunk, n_p)
            # the chunk's source z range, over the corners of its box
            ends = [(t0, t1 - 1) if a == projection_axis
                    else (0, out_shape[a] - 1) for a in range(3)]
            z_lo = rows[0][3] + sum(min(c * e[0], c * e[1])
                                    for c, e in zip(rows[0], ends))
            z_hi = rows[0][3] + sum(max(c * e[0], c * e[1])
                                    for c, e in zip(rows[0], ends))
            if z_hi < off - 2 or z_lo > off + local + 1:
                continue
            w = dict(grids)
            w[projection_axis] = planes[t0:t1]
            s = [rows[r][0] * w[0] + rows[r][1] * w[1] + rows[r][2] * w[2]
                 + rows[r][3] for r in range(3)]
            inside = ((s[0] >= 0) & (s[0] <= out_shape[0] - 1)
                      & (s[1] >= 0) & (s[1] <= out_shape[1] - 1)
                      & (s[2] >= 0) & (s[2] <= out_shape[2] - 1))
            val = _trilinear3d_pertap(x_slab, s[0] - off, s[1], s[2])
            result[n] += torch.where(inside, val, 0.0).sum(dim=0)
    return result


def sum_order_atol(n_planes: int, largest: float) -> float:
    """How far :func:`partial_project` may lie from
    :func:`plain_partial_project`: both sum the same ``n_planes``
    per-plane samples of each ray, bit for bit alike, in two orders; each
    sum lies within ``(n_planes - 1) 2**-24`` of the exact sum of the
    terms' magnitudes, which is at most ``largest``, the largest value of
    :func:`plain_partial_project` of the slab's magnitudes (the weights
    are not negative)."""
    return 2 * (n_planes - 1) * 2.0 ** -24 * largest


def line_axis(matrices, projection_axis: int):
    """The ray axis ``r`` (one of the two axes other than
    ``projection_axis``) that every matrix leaves alone
    (:func:`_leaves_alone`), the second ray axis tried first (the one
    :func:`partial_project`'s line path takes); None where neither
    qualifies."""
    keep = [a for a in range(3) if a != projection_axis]
    for r in keep[::-1]:
        if _leaves_alone(matrices, r):
            return r
    return None


def partial_project(x_slab: torch.Tensor, matrices, off: float, out_shape,
                    projection_axis: int,
                    _force_general: bool = False) -> torch.Tensor:
    """The slab's partial projections, (N, A, B) float32 on its device:
    ``x_slab`` (contiguous float32, (local, H, W), its first plane at
    global z ``off``) through ``matrices`` ((N, 4, 4) float32 numpy
    pull-back matrices) into projections of the global ``out_shape`` along
    ``projection_axis`` (0-2); A and B are the extents of the other two
    axes, in order.  On the card one launch for all tilts, counted as
    ``"partial_project"``; it sums each ray's planes in order, the
    plain version in chunks, within :func:`sum_order_atol`.  Where
    :func:`line_axis` gives the second ray axis the launch takes the line
    path (also counted as ``"partial_project.line"``), equal to the
    general kernel bit for bit on a finite slab; ``_force_general`` keeps
    it on the general kernel, the line path's reference."""
    out_shape = tuple(int(s) for s in out_shape)
    matrices = np.asarray(matrices)
    if not isinstance(x_slab, torch.Tensor):
        raise TypeError("the slab must be a torch tensor")
    if x_slab.dtype != torch.float32 or x_slab.ndim != 3 \
            or min(x_slab.shape) < 1 or not x_slab.is_contiguous():
        raise ValueError(f"the slab must be a non-empty contiguous float32 "
                         f"3-D tensor, got {x_slab.dtype} "
                         f"{tuple(x_slab.shape)}")
    if len(out_shape) != 3 or tuple(x_slab.shape[1:]) != out_shape[1:]:
        raise ValueError(f"the slab {tuple(x_slab.shape)} does not hold "
                         f"planes of a volume of shape {out_shape}")
    if matrices.dtype != np.float32 or matrices.ndim != 3 \
            or matrices.shape[1:] != (4, 4):
        raise ValueError(f"matrices must be (N, 4, 4) float32, got "
                         f"{matrices.dtype} {matrices.shape}")
    if projection_axis not in (0, 1, 2):
        raise ValueError(f"projection_axis must be 0, 1 or 2, got "
                         f"{projection_axis!r}")
    if x_slab.device.type == "cpu":
        return plain_partial_project(x_slab, matrices, off, out_shape,
                                     projection_axis)
    if x_slab.device.type != "cuda":
        raise ValueError(f"unsupported device {x_slab.device}")
    keep = [a for a in range(3) if a != projection_axis]
    out = torch.empty((len(matrices), out_shape[keep[0]],
                       out_shape[keep[1]]), dtype=torch.float32,
                      device=x_slab.device)
    if len(matrices) == 0:
        return out
    line = keep[1] if not _force_general and _leaves_alone(
        matrices, keep[1]) else 0
    with torch.cuda.device(x_slab.device):
        # the rows go up through pinned memory without blocking, in stream
        # order, so the call does not wait for the device
        rows = torch.from_numpy(np.ascontiguousarray(matrices[:, :3])) \
            .pin_memory().to(x_slab.device, non_blocking=True)
    (_PROJECT_LINE if line else _PROJECT)(
        x_slab.device,
        x_slab.data_ptr(), *x_slab.shape, rows.data_ptr(), len(matrices),
        float(off), *out_shape, projection_axis, line, out.data_ptr())
    return out

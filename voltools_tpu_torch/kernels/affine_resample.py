"""The affine resampling kernel: CUDA for CUDA tensors, plain torch on the CPU.

:func:`affine_resample` is the port of the TPU plane-walk Pallas kernel
(``voltools_tpu/kernels/pallas_walk.py::_make_walk_kernel``).  For a CUDA
volume it launches ``csrc/affine_resample.cu`` (built by ``nvcc`` at first
use, see :mod:`._build`) on the current stream without synchronising; for a
CPU volume it runs the kernel's plain version, :func:`affine_sample` /
:func:`affine_sample_batch` of :mod:`voltools_tpu_torch.ops.sampling`.  A
CUDA tensor never falls back to the plain version: the launch succeeds or
the call raises.

The volume given is sampled as it is: for ``order=3`` it holds B-spline
coefficients already (``filt_bspline`` prefilters first) or raw samples
(``bspline``).  It is contiguous or row-pitched (:mod:`.layout`): the
kernel takes the row pitch, so the pitched resident volume that the slab
kernel needs serves this one too; where its rows start on 16-byte
boundaries (:func:`vector_rows`), the cubic fast path reads them as
aligned float4 loads.  Each launch runs with one of two warp patches,
``FLAT_PATCH`` or ``DEEP_PATCH`` (the planner's ``walk_patch`` picks it);
the result does not depend on it.  The kernel counts, on the device, the
in-range voxels that took its interior fast path: :func:`fast_path_voxels`
reads the count.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.sampling import affine_sample, affine_sample_batch
from . import _build
from .layout import ROW_ALIGN, row_pitch

NAME = "affine_resample"
SOURCE = "voltools_tpu_torch/csrc/affine_resample.cu"
REPLACES = "voltools_tpu/kernels/pallas_walk.py:1140"

# grid.y runs over the matrices of one launch
MAX_BATCH = 65535
# the two warp patches of 32 output voxels along (z, y, x) a launch
# chooses between (the kernel's kFlat*, kDeep*)
FLAT_PATCH = (1, 4, 8)
DEEP_PATCH = (2, 2, 8)

_MODES = {"constant": 0, "border": 1}
_PLAIN_INTERPOLATION = {1: "linear", 3: "bspline"}


# affine_resample_launch's parameters
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # volume
    ctypes.c_int,                                               # pitch
    ctypes.c_void_p, ctypes.c_int,                              # matrices
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # output
    ctypes.c_int, ctypes.c_int,                         # order, border
    ctypes.c_int, ctypes.c_int,                 # float4 rows, deep patch
    ctypes.c_float,                                             # cval
    ctypes.c_void_p,                                       # fast-path count
    ctypes.c_void_p,                                            # stream
]
# its fast-path counter is affine_resample_count_words() int64 words:
# slots of a 128-byte line each, of which the kernel adds to the first
# word alone, so their sum is the count
LIBRARY = _build.Library(
    NAME, {"affine_resample_launch": ARGTYPES,
           "affine_resample_count_words": []},
    counters={"fast_path_voxels": (torch.int64,
                                   "affine_resample_count_words")})
_LAUNCH = LIBRARY.launcher("affine_resample_launch", NAME)


def fast_path_voxels(device="cuda") -> int:
    """The in-range output voxels (those whose source point lies inside the
    volume, by the launch's mode) that the kernel computed on its interior
    fast path on ``device``, counted on the device by every launch since
    the last :func:`reset_fast_path_voxels` in this process.  Trilinear
    runs the edge path alone and counts none.  Reading it waits for the
    device."""
    return LIBRARY.read("fast_path_voxels", device)


def reset_fast_path_voxels(device="cuda") -> None:
    """Set the fast-path counter of ``device`` to 0 (in stream order)."""
    LIBRARY.reset("fast_path_voxels", device)


def _check(volume, matrices, order, mode, out_shape, out):
    """Validate the arguments; returns the full output shape.  The volume
    is contiguous or row-pitched, the other tensors contiguous."""
    if not isinstance(volume, torch.Tensor) or not isinstance(
            matrices, torch.Tensor):
        raise TypeError("volume and matrices must be torch tensors")
    if volume.dtype != torch.float32 or matrices.dtype != torch.float32:
        raise ValueError(
            f"volume and matrices must be float32, got {volume.dtype} and "
            f"{matrices.dtype}")
    if volume.ndim != 3 or min(volume.shape) < 1:
        raise ValueError(
            f"volume must be a non-empty 3-D tensor, got {tuple(volume.shape)}")
    if matrices.ndim not in (2, 3) or tuple(matrices.shape[-2:]) != (4, 4):
        raise ValueError(
            f"matrices must be (4, 4) or (N, 4, 4), got "
            f"{tuple(matrices.shape)}")
    row_pitch(volume)
    if not matrices.is_contiguous():
        raise ValueError("matrices must be contiguous")
    if matrices.device != volume.device:
        raise ValueError(
            f"matrices on {matrices.device}, volume on {volume.device}")
    if order not in _PLAIN_INTERPOLATION:
        raise ValueError(f"order must be 1 or 3, got {order!r}")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}, got {mode!r}")
    if len(out_shape) != 3 or min(out_shape) < 1:
        raise ValueError(f"out_shape must be 3 positive extents, got {out_shape}")
    full = out_shape if matrices.ndim == 2 else (matrices.shape[0],) + out_shape
    if out is not None:
        if not isinstance(out, torch.Tensor) or out.dtype != torch.float32:
            raise ValueError("out must be a float32 torch tensor")
        if tuple(out.shape) != full:
            raise ValueError(
                f"out shape {tuple(out.shape)} does not match result shape "
                f"{full}")
        if out.device != volume.device or not out.is_contiguous():
            raise ValueError(
                f"out must be contiguous and on {volume.device}")
        if out.untyped_storage().data_ptr() == \
                volume.untyped_storage().data_ptr():
            raise ValueError("out must not share memory with the volume")
    return full


def _plain(volume, matrices, order, mode, cval, out_shape, out):
    """The kernels' plain version, for CPU tensors."""
    plain = affine_sample if matrices.ndim == 2 else affine_sample_batch
    result = plain(volume, matrices, _PLAIN_INTERPOLATION[order], mode,
                   cval, prefiltered=True, out_shape=out_shape)
    if out is None:
        return result
    return out.copy_(result)


def _check_launch(volume, matrices, max_batch=MAX_BATCH) -> int:
    """Limits of a CUDA launch; returns the number of matrices."""
    if volume.device.type != "cuda":
        raise ValueError(f"unsupported device {volume.device}")
    n = 1 if matrices.ndim == 2 else matrices.shape[0]
    if max_batch is not None and n > max_batch:
        raise ValueError(f"at most {max_batch} matrices per launch, got {n}")
    if volume.shape[1] * row_pitch(volume) >= 2 ** 31:
        raise ValueError("a z-plane of the volume must hold < 2**31 voxels")
    return n


def vector_rows(volume: torch.Tensor) -> bool:
    """Whether the kernel may read ``volume``'s rows as aligned float4
    loads: its rows start on 16-byte boundaries (a row pitch that is a
    multiple of ``ROW_ALIGN`` floats and 16-byte aligned storage), as a
    pitched resident volume's do, and its storage holds the last row's
    padding (an aligned float4 may reach into it).  Other volumes are read
    a float at a time."""
    pitch = row_pitch(volume)
    d0, d1, _ = volume.shape
    end = (volume.storage_offset() + d0 * d1 * pitch) * volume.element_size()
    return (pitch % ROW_ALIGN == 0 and volume.data_ptr() % 16 == 0
            and end <= volume.untyped_storage().nbytes())


def affine_resample(volume: torch.Tensor, matrices: torch.Tensor, order: int,
                    mode: str = "constant", cval: float = 0.0,
                    out_shape=None, out: torch.Tensor = None,
                    patch=FLAT_PATCH) -> torch.Tensor:
    """Resample ``volume`` (D, H, W) through pull-back ``matrices``.

    ``matrices`` is one (4, 4) matrix, giving an ``out_shape`` result, or a
    stack (N, 4, 4), giving (N, *out_shape) in one launch.  ``out_shape``
    defaults to the volume's shape.  ``out``, when given, is a contiguous
    float32 tensor of the result's shape on the volume's device; the result
    is written into it and it is returned.  All tensors are float32 and on
    one device; the volume is contiguous or row-pitched (:mod:`.layout`),
    the others contiguous.  ``patch`` is the warp patch of the launch,
    ``FLAT_PATCH`` or ``DEEP_PATCH`` (the planner's
    :func:`~.planner.walk_patch` picks it; the result is the same).
    ``_build.launches()["affine_resample"]`` counts the kernel launches
    (the CPU path launches nothing), :func:`fast_path_voxels` the in-range
    voxels that took the kernel's interior fast path."""
    out_shape = (tuple(volume.shape) if out_shape is None
                 else tuple(int(s) for s in out_shape))
    full = _check(volume, matrices, order, mode, out_shape, out)
    if tuple(patch) not in (FLAT_PATCH, DEEP_PATCH):
        raise ValueError(
            f"patch must be {FLAT_PATCH} or {DEEP_PATCH}, got {patch!r}")

    if volume.device.type == "cpu":
        return _plain(volume, matrices, order, mode, cval, out_shape, out)
    n = _check_launch(volume, matrices)
    if out is None:
        out = torch.empty(full, dtype=torch.float32, device=volume.device)
    if n == 0:
        return out
    if matrices.data_ptr() % 16:
        # the kernel reads each matrix row as one 16-byte load
        matrices = matrices.clone()
    _LAUNCH(volume.device,
            volume.data_ptr(), *volume.shape, row_pitch(volume),
            matrices.data_ptr(), n,
            out.data_ptr(), *out_shape, order, _MODES[mode],
            int(vector_rows(volume)), int(tuple(patch) == DEEP_PATCH),
            float(cval),
            LIBRARY.counter("fast_path_voxels", volume.device).data_ptr())
    return out

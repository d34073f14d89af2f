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
(``bspline``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.sampling import affine_sample, affine_sample_batch
from . import _build

NAME = "affine_resample"
SOURCE = "voltools_tpu_torch/csrc/affine_resample.cu"
REPLACES = "voltools_tpu/kernels/pallas_walk.py:1140"

# grid.y runs over the matrices of one launch
MAX_BATCH = 65535

_MODES = {"constant": 0, "border": 1}
_PLAIN_INTERPOLATION = {1: "linear", 3: "bspline"}


@functools.lru_cache(maxsize=1)
def _library():
    lib = _build.load(NAME)
    fn = lib.affine_resample_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # volume
        ctypes.c_void_p, ctypes.c_int,                              # matrices
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # output
        ctypes.c_int, ctypes.c_int, ctypes.c_float,       # order, border, cval
        ctypes.c_void_p,                                  # stream
    ]
    fn.restype = ctypes.c_int
    lib.affine_resample_error_string.argtypes = [ctypes.c_int]
    lib.affine_resample_error_string.restype = ctypes.c_char_p
    return lib


def _check(volume, matrices, order, mode, out_shape, out):
    """Validate the arguments; returns the full output shape."""
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
    if not (volume.is_contiguous() and matrices.is_contiguous()):
        raise ValueError("volume and matrices must be contiguous")
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


def affine_resample(volume: torch.Tensor, matrices: torch.Tensor, order: int,
                    mode: str = "constant", cval: float = 0.0,
                    out_shape=None, out: torch.Tensor = None) -> torch.Tensor:
    """Resample ``volume`` (D, H, W) through pull-back ``matrices``.

    ``matrices`` is one (4, 4) matrix, giving an ``out_shape`` result, or a
    stack (N, 4, 4), giving (N, *out_shape) in one launch.  ``out_shape``
    defaults to the volume's shape.  ``out``, when given, is a contiguous
    float32 tensor of the result's shape on the volume's device; the result
    is written into it and it is returned.  All tensors are float32,
    contiguous and on one device.  ``affine_resample.launches`` counts the
    kernel launches (the CPU path launches nothing)."""
    out_shape = (tuple(volume.shape) if out_shape is None
                 else tuple(int(s) for s in out_shape))
    full = _check(volume, matrices, order, mode, out_shape, out)

    if volume.device.type == "cpu":
        plain = affine_sample if matrices.ndim == 2 else affine_sample_batch
        result = plain(volume, matrices, _PLAIN_INTERPOLATION[order], mode,
                       cval, prefiltered=True, out_shape=out_shape)
        if out is None:
            return result
        return out.copy_(result)
    if volume.device.type != "cuda":
        raise ValueError(f"unsupported device {volume.device}")

    n = 1 if matrices.ndim == 2 else matrices.shape[0]
    if n > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} matrices per launch, got {n}")
    if volume.shape[1] * volume.shape[2] >= 2 ** 31:
        raise ValueError("a z-plane of the volume must hold < 2**31 voxels")
    if out is None:
        out = torch.empty(full, dtype=torch.float32, device=volume.device)
    if n == 0:
        return out
    lib = _library()
    # the launch goes to the current device; make it the volume's for the
    # call only, so the caller's current device is left as it was
    with torch.cuda.device(volume.device):
        code = lib.affine_resample_launch(
            volume.data_ptr(), *volume.shape, matrices.data_ptr(), n,
            out.data_ptr(), *out_shape, order, _MODES[mode], float(cval),
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        message = lib.affine_resample_error_string(code).decode()
        raise RuntimeError(f"affine_resample launch failed: {message} ({code})")
    affine_resample.launches += 1
    return out


affine_resample.launches = 0

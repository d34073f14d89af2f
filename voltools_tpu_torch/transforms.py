"""Public one-shot transform API.

The port's counterpart of ``voltools_tpu/transforms.py``: ``transform``,
``affine``, ``translate``, ``shear``, ``scale`` and ``rotate``, each taking
``interpolation``, ``reshape``, ``profile``, ``output``, ``device``, ``mode``
and ``cval``.

Devices: ``'cuda'`` (the default) and ``'cuda:N'`` run the CUDA affine
kernel, after the B-spline prefilter for ``filt_bspline*``; ``'cpu'`` runs
the port's plain torch versions and is only taken when asked for.  With no
CUDA device the default raises.

Output semantics (as the JAX package's device paths): inputs are never
mutated.  By default a host ``numpy.ndarray`` is returned.  Passing
``output=<numpy array>`` fills that array, after an exact shape and dtype
check, and returns ``None``.  Passing ``output='device'`` returns the CUDA
tensor without a device-to-host copy.
"""

from __future__ import annotations

import numbers
import threading
from typing import Tuple, Union

import numpy as np
import torch

from .kernels.affine_resample import affine_resample
from .ops.interpolation import (AVAILABLE_INTERPOLATIONS, MODES,
                                needs_prefilter, spline_order)
from .ops.prefilter import bspline_prefilter
from .utils import (
    ProfileTimer,
    compute_post_transform_dimensions,
    get_available_devices,
    resolve_device,
    rotation_matrix,
    scale_matrix,
    shear_matrix,
    transform_matrix,
    translation_matrix,
)

Triple = Union[float, Tuple[float, float, float], np.ndarray]


class PerformanceFallbackWarning(RuntimeWarning):
    """Kept for API parity with the JAX package, where a matrix outside the
    Pallas kernels' regime falls back to a slower path.  The CUDA affine
    kernel serves every matrix, so the port never issues it."""


_LAST_DISPATCH = threading.local()


def last_dispatch():
    """Diagnostics: how the calling thread's most recent transform was
    served -- ``{'impl': 'cuda'|'torch', 'variant': None, 'reason': str}``.
    ``'cuda'`` is the CUDA affine kernel, ``'torch'`` the plain version on
    the CPU."""
    return getattr(_LAST_DISPATCH, "info", None)


def _as_triple(value):
    # numbers.Number catches numpy scalars; a 0-d numpy array is a scalar
    # all the same
    if isinstance(value, numbers.Number) or (
            isinstance(value, np.ndarray) and value.ndim == 0):
        return (float(value),) * 3
    return value


def _check_shape(output_shape, result_shape):
    if tuple(output_shape) != tuple(result_shape):
        raise ValueError(
            f"output shape {tuple(output_shape)} does not match result "
            f"shape {tuple(result_shape)}")


def _finish(result_np, output):
    if output is None:
        return result_np
    # exact-shape check: np.copyto would broadcast a result into a
    # wrong-shaped buffer
    _check_shape(output.shape, result_np.shape)
    if not np.can_cast(result_np.dtype, output.dtype, casting="same_kind"):
        raise ValueError(
            f"output dtype {output.dtype} cannot hold {result_np.dtype} "
            f"results without unsafe casting")
    np.copyto(output, result_np)
    return None


def _as_tensor(data, device: torch.device) -> torch.Tensor:
    """``data`` (numpy array or tensor) as a float32 tensor on ``device``.
    A read-only numpy array is copied first: torch cannot wrap one."""
    if isinstance(data, np.ndarray) and not data.flags.writeable:
        data = np.array(data)
    return torch.as_tensor(data, dtype=torch.float32, device=device)


def _device_matrices(matrices: np.ndarray, device: torch.device):
    """float32 matrices as a tensor on ``device``.  A CUDA copy goes through
    pinned memory without blocking, so it does not wait for the stream."""
    host = torch.from_numpy(np.ascontiguousarray(matrices, dtype=np.float32))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def _record(device: torch.device):
    """Note for :func:`last_dispatch` which path served this thread's call."""
    if device.type == "cuda":
        _LAST_DISPATCH.info = dict(impl="cuda", variant=None,
                                   reason="CUDA affine kernel")
    else:
        _LAST_DISPATCH.info = dict(impl="torch", variant=None,
                                   reason="plain torch sampler (device='cpu')")


def _check_output(output, device: str):
    if output is None or isinstance(output, np.ndarray):
        return
    if isinstance(output, str) and output == "device":
        if device == "cpu":
            raise ValueError("output='device' requires a CUDA device")
        return
    raise ValueError(
        "output must be None, a numpy array to fill, or 'device' to keep "
        "the result on the CUDA device (StaticVolume.affine also takes a "
        f"preallocated tensor); got {output!r}")


def affine(volume,
           transform_m: np.ndarray,
           interpolation: str = "linear",
           reshape: bool = False,
           profile: bool = False,
           output=None,
           device: str = "cuda",
           mode: str = "constant",
           cval: float = 0.0):
    """Apply a 4x4 pull-back matrix to a 3-D volume (numpy array or tensor).

    The chain is the prefilter (``filt_bspline*`` only), then one launch of
    the affine kernel -- the one-shot program of the JAX package
    (``pallas_walk.py:1874-1892``).  ``reshape=True`` samples onto the
    enlarged grid that holds the whole transformed volume, through the
    pad-shifted matrix."""
    if volume.ndim != 3:
        raise ValueError("Expected a 3D array")
    if interpolation not in AVAILABLE_INTERPOLATIONS:
        raise ValueError(
            f"Interpolation must be one of {AVAILABLE_INTERPOLATIONS}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    available = get_available_devices()
    if device not in available:
        raise ValueError(
            f"Unknown device ({device}), must be one of {available}")
    _check_output(output, device)
    dev = resolve_device(device)

    transform_m = np.asarray(transform_m, dtype=np.float32)
    out_shape = tuple(int(d) for d in volume.shape)
    if reshape:
        pad_before, _, new_dims = compute_post_transform_dimensions(
            out_shape, transform_m)
        transform_m = transform_m @ translation_matrix(pad_before,
                                                       transform_m.dtype)
        out_shape = tuple(int(d) for d in new_dims)
    if isinstance(output, np.ndarray):
        _check_shape(output.shape, out_shape)

    timer = ProfileTimer() if profile else None
    if timer:
        timer.__enter__()
    try:
        vol = _as_tensor(volume, dev).contiguous()
        if needs_prefilter(interpolation):
            vol = bspline_prefilter(vol)
        result = affine_resample(vol, _device_matrices(transform_m, dev),
                                 spline_order(interpolation), mode,
                                 float(cval), out_shape)
        _record(dev)
        if isinstance(output, str):
            return result
        return _finish(result.cpu().numpy(), output)
    finally:
        if timer:
            timer.__exit__(None, None, None)


def transform(volume,
              scale: Triple = None,
              shear: Triple = None,
              rotation: Triple = None,
              rotation_units: str = "deg",
              rotation_order: str = "rzxz",
              translation: Triple = None,
              center: Triple = None,
              interpolation: str = "linear",
              reshape: bool = False,
              profile: bool = False,
              output=None,
              device: str = "cuda",
              mode: str = "constant",
              cval: float = 0.0):
    """Compose scale/shear/rotation/translation about ``center`` and apply.

    ``center`` defaults to the volume midpoint ``(shape - 1) / 2``
    (reference ``transforms.py:38-39``).
    """
    if center is None:
        center = np.divide(np.subtract(tuple(volume.shape), 1), 2,
                           dtype=np.float32)
    m = transform_matrix(_as_triple(scale), _as_triple(shear),
                         _as_triple(rotation), rotation_units, rotation_order,
                         _as_triple(translation), _as_triple(center))
    return affine(volume, m, interpolation, reshape, profile, output, device,
                  mode, cval)


def translate(volume,
              translation: Tuple[float, float, float],
              interpolation: str = "linear",
              reshape: bool = False,
              profile: bool = False,
              output=None,
              device: str = "cuda",
              **kw):
    return affine(volume, translation_matrix(translation), interpolation,
                  reshape, profile, output, device, **kw)


def shear(volume,
          coefficients: Triple,
          interpolation: str = "linear",
          reshape: bool = False,
          profile: bool = False,
          output=None,
          device: str = "cuda",
          **kw):
    return affine(volume, shear_matrix(_as_triple(coefficients)),
                  interpolation, reshape, profile, output, device, **kw)


def scale(volume,
          coefficients: Triple,
          interpolation: str = "linear",
          reshape: bool = False,
          profile: bool = False,
          output=None,
          device: str = "cuda",
          **kw):
    return affine(volume, scale_matrix(_as_triple(coefficients)),
                  interpolation, reshape, profile, output, device, **kw)


def rotate(volume,
           rotation: Tuple[float, float, float],
           rotation_units: str = "deg",
           rotation_order: str = "rzxz",
           interpolation: str = "linear",
           reshape: bool = False,
           profile: bool = False,
           output=None,
           device: str = "cuda",
           **kw):
    """Rotate about the origin (no implicit centering -- use ``transform``
    for center-relative rotation, reference ``transforms.py:95-106``)."""
    m = rotation_matrix(rotation=rotation, rotation_units=rotation_units,
                        rotation_order=rotation_order)
    return affine(volume, m, interpolation, reshape, profile, output, device,
                  **kw)

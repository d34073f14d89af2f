"""Public one-shot transform API.

The port's counterpart of ``voltools_tpu/transforms.py``: ``transform``,
``affine``, ``translate``, ``shear``, ``scale`` and ``rotate``, each taking
``interpolation``, ``reshape``, ``profile``, ``output``, ``device``, ``mode``
and ``cval``.

Devices: ``'cuda'`` (the default) and ``'cuda:N'`` run one of the two CUDA
affine kernels, after the B-spline prefilter for ``filt_bspline*``: the
slab kernel where :func:`~.kernels.planner.route` finds that the matrix's
source box fits its shared-memory budget and the slab kernel is the faster
one for it, the walk kernel otherwise.  Both compute the same function,
bit for bit.  The slab kernel reads a pitched volume
(:mod:`~.kernels.layout`); a volume that is not is copied into one first.
``'cpu'`` runs the port's plain torch versions and is only taken when
asked for.  With no CUDA device the default raises.  ``affine(...,
device='cpu', cpu_backend='scipy'|'native')`` takes the JAX package's CPU
backends instead: ``scipy.ndimage.affine_transform`` or the multithreaded
C++ resampler (:mod:`~.native`).

Output semantics (as the JAX package's device paths): inputs are never
mutated.  By default a host ``numpy.ndarray`` is returned.  Passing
``output=<numpy array>`` fills that array, after an exact shape and dtype
check, and returns ``None``.  Passing ``output='device'`` returns the CUDA
tensor without a device-to-host copy.  The CPU backends keep the JAX
package's CPU contract: given ``output=<numpy array>`` they fill it and
return it.
"""

from __future__ import annotations

import contextlib
import numbers
import threading
from typing import Tuple, Union

import numpy as np
import torch

from . import native
from .kernels.affine_resample import affine_resample
from .kernels.affine_slab import affine_slab
from .kernels.layout import pitched
from .kernels.planner import route, walk_patch
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
    Pallas kernels' regime falls back to a slower path.  The port's walk
    kernel serves every matrix, so the port never issues it."""


_LAST_DISPATCH = threading.local()


def last_dispatch():
    """Diagnostics: how the calling thread's most recent transform was
    served -- ``{'impl': 'cuda'|'torch', 'variant': SlabPlan|None,
    'rule': 'box'|'speed', 'reason': str}``.  ``'cuda'`` is a CUDA kernel,
    ``'torch'`` the plain version on the CPU.  ``variant`` is the planner's
    :class:`~.kernels.planner.SlabPlan` when the slab kernel took the call
    (or would have, on the CPU), ``None`` for the walk kernel; ``rule`` is
    the planner's rule that picked the kernel (the box rule: the slab kernel
    cannot take the call; the speed rule: which kernel is faster for it),
    and ``reason`` names the kernel and the rule's numbers."""
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


def _device(device: str) -> torch.device:
    """The ``torch.device`` of a device string that names a usable device;
    any other raises."""
    available = get_available_devices()
    if device not in available:
        raise ValueError(
            f"Unknown device ({device}), must be one of {available}")
    return resolve_device(device)


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


def _resample(vol: torch.Tensor, matrices: np.ndarray, interpolation: str,
              mode: str, cval: float, out_shape=None,
              out: torch.Tensor = None) -> torch.Tensor:
    """Resample ``vol`` through host ``matrices`` ((4, 4) or (N, 4, 4)) in
    one launch of the kernel the planner routes them to, and note the
    choice for :func:`last_dispatch`.  A CUDA volume that the slab kernel
    is to read and that is not pitched is copied into a pitched one here,
    inside the call."""
    out_shape = tuple(vol.shape) if out_shape is None else tuple(out_shape)
    order = spline_order(interpolation)
    plan, rule, why = route(matrices, vol.shape, interpolation, mode,
                            out_shape)
    mats = _device_matrices(matrices, vol.device)
    if plan is not None:
        if vol.device.type == "cuda":
            vol = pitched(vol)
        result = affine_slab(vol, mats, order, mode, cval, out_shape, out,
                             plan=plan)
        kernel = "slab kernel (affine_slab)"
    else:
        patch = walk_patch(matrices)
        result = affine_resample(vol, mats, order, mode, cval, out_shape,
                                 out, patch=patch)
        kernel = f"walk kernel (affine_resample, warp patch {patch})"
    kernel = f"{kernel} by the {rule} rule: {why}"
    if vol.device.type == "cuda":
        _LAST_DISPATCH.info = dict(impl="cuda", variant=plan, rule=rule,
                                   reason=f"CUDA {kernel}")
    else:
        _LAST_DISPATCH.info = dict(
            impl="torch", variant=plan, rule=rule,
            reason=f"plain torch sampler (device='cpu') in place of the "
                   f"{kernel}")
    return result


def _affine_cpu(volume, transform_m, interpolation, reshape, output,
                backend: str, mode: str, cval: float):
    """The JAX package's ``device='cpu'`` backends
    (``voltools_tpu/transforms.py:112-165``): scipy or the native C++
    resampler on host arrays, ``mode='border'`` forced onto the native one;
    with ``output=<ndarray>`` the filled array is returned."""
    if backend not in ("scipy", "native"):
        raise ValueError(
            f"cpu_backend must be 'scipy' or 'native', got {backend!r}")
    if mode == "border" and backend != "native":
        # scipy has no texture-border mode; the native backend implements it
        if not native.available():
            raise ValueError(
                "mode='border' on device='cpu' requires the native backend "
                "(cpu_backend='native'), which is unavailable on this host")
        backend = "native"
    if reshape:
        pad_before, _, output_shape = compute_post_transform_dimensions(
            volume.shape, transform_m)
        # scipy pads implicitly via output_shape; shift the map so the
        # original content lands pad_before voxels in
        transform_m = transform_m @ translation_matrix(
            pad_before, np.asarray(transform_m).dtype)
        output_shape = tuple(int(d) for d in output_shape)
    else:
        output_shape = volume.shape
    fill = output if isinstance(output, np.ndarray) else None
    if fill is not None:
        _check_shape(fill.shape, output_shape)

    if backend == "native":
        out = native.affine_transform(volume, transform_m, interpolation,
                                      mode=mode, cval=cval,
                                      out_shape=output_shape, output=fill)
    else:
        from scipy.ndimage import affine_transform
        out = affine_transform(volume, transform_m,
                               output_shape=output_shape, output=fill,
                               order=spline_order(interpolation),
                               prefilter=needs_prefilter(interpolation),
                               cval=cval)
    return fill if fill is not None else out


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
           cval: float = 0.0,
           cpu_backend: str = None):
    """Apply a 4x4 pull-back matrix to a 3-D volume (numpy array or tensor).

    The chain is the prefilter (``filt_bspline*`` only), then one launch of
    the kernel the planner chooses -- the one-shot program of the JAX
    package (``pallas_walk.py:1874-1892``).  ``reshape=True`` samples onto the
    enlarged grid that holds the whole transformed volume, through the
    pad-shifted matrix.

    ``cpu_backend`` (``device='cpu'`` only): ``None`` runs the plain torch
    version; ``'scipy'`` or ``'native'`` the JAX package's CPU backends,
    which return the filled ``output`` array when given one."""
    if volume.ndim != 3:
        raise ValueError("Expected a 3D array")
    if interpolation not in AVAILABLE_INTERPOLATIONS:
        raise ValueError(
            f"Interpolation must be one of {AVAILABLE_INTERPOLATIONS}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dev = _device(device)
    _check_output(output, device)
    if cpu_backend is not None and dev.type != "cpu":
        raise ValueError(
            f"cpu_backend={cpu_backend!r} applies to device='cpu' only, "
            f"not {device!r}")

    timer = ProfileTimer(dev) if profile else contextlib.nullcontext()
    if cpu_backend is not None:
        if isinstance(volume, torch.Tensor):
            volume = volume.detach().cpu().numpy()
        with timer:
            return _affine_cpu(volume, np.asarray(transform_m),
                               interpolation, reshape, output, cpu_backend,
                               mode, cval)

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

    with timer:
        vol = _as_tensor(volume, dev).contiguous()
        if needs_prefilter(interpolation):
            vol = bspline_prefilter(vol)
        result = _resample(vol, transform_m, interpolation, mode,
                           float(cval), out_shape)
        if isinstance(output, str):
            return result
        return _finish(result.cpu().numpy(), output)


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

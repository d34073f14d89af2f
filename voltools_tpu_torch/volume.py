"""StaticVolume: a device-resident volume for repeated transforms.

The port's counterpart of ``voltools_tpu/volume.py``: upload once, prefilter
once (for ``filt_bspline*``), then every transform ships only a 4x4 matrix
to the device and launches a CUDA affine kernel on the resident tensor:
the slab kernel where the planner finds its box fits and it is the faster
kernel, the walk kernel otherwise
(:func:`voltools_tpu_torch.transforms._resample`).  The resident volume is
pitched (:mod:`voltools_tpu_torch.kernels.layout`): its rows start every
multiple of 4 floats, as the slab kernel's TMA copies need, and the walk
kernel and the plain version read the same buffer.

* ``affine(output=<tensor>)`` writes into a preallocated float32 tensor of
  the volume's shape on the volume's device, in place: the torch form of
  the JAX package's buffer donation (``pallas_walk.py:1989-2010``).
* ``affine_batch`` applies N matrices in one launch, chunked so that the
  device holds at most about 2 GB of output at a time; each chunk is
  planned as one envelope.
* ``reshape`` is unsupported, as in the reference (``volume.py:14-16``).
* On ``device='cpu'`` the volume is a private float32 tensor and the
  kernel's plain torch version samples it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .kernels.affine_resample import MAX_BATCH
from .kernels.layout import pitched
from .ops.interpolation import (AVAILABLE_INTERPOLATIONS, MODES,
                                needs_prefilter)
from .ops.prefilter import BOUNDARIES, bspline_prefilter
from .transforms import (_as_tensor, _as_triple, _check_output,
                         _check_shape, _device, _finish, _resample)
from .utils import (
    ProfileTimer,
    rotation_matrix,
    scale_matrix,
    shear_matrix,
    transform_matrix,
    translation_matrix,
)
from .utils import trace

Triple = Union[float, Tuple[float, float, float], np.ndarray]


class StaticVolume:
    """Keeps a (prefiltered) float32 volume resident on a device for cheap
    repeated transforms.  ``reshape`` is not available on this API.

    ``autotune`` is accepted for API parity and does nothing: the JAX
    package tunes among TPU kernel plans by measuring them, and the port's
    planner chooses between its two kernels from the matrices alone."""

    # keep the device output stack under ~2 GB per launch
    _BATCH_BYTES_BUDGET = 2 << 30

    @classmethod
    def batch_chunk(cls, shape) -> int:
        """How many float32 volumes of ``shape`` one launch resamples: as
        many as fit ``_BATCH_BYTES_BUDGET``, at least one, at most the
        kernels' ``MAX_BATCH``."""
        vol_bytes = 4 * int(np.prod(shape))
        return max(1, min(MAX_BATCH, cls._BATCH_BYTES_BUDGET // vol_bytes))

    def __init__(self, data, interpolation: str = "linear",
                 device: str = "cuda", mode: str = "constant",
                 cval: float = 0.0, prefilter_boundary: str = "mirror",
                 autotune: Optional[int] = None):
        if prefilter_boundary not in BOUNDARIES:
            raise ValueError(
                f"prefilter_boundary must be one of {BOUNDARIES}, "
                f"got {prefilter_boundary!r}")
        self._configure(data, interpolation, device, mode, cval)
        self._autotune = autotune
        vol = _as_tensor(data, self._dev)
        if needs_prefilter(interpolation):
            self.data = pitched(bspline_prefilter(
                vol, boundary=prefilter_boundary))
        else:
            # private copy: later caller mutation of the input must not
            # change results
            self.data = pitched(vol, copy=True)

    def _configure(self, data, interpolation, device, mode, cval):
        if data.ndim != 3:
            raise ValueError("Expected a 3D array")
        if interpolation not in AVAILABLE_INTERPOLATIONS:
            raise ValueError(
                f"Interpolation must be one of {AVAILABLE_INTERPOLATIONS}")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self._dev = _device(device)
        self.device = device
        self.interpolation = interpolation
        self.mode = mode
        self.cval = float(cval)
        self.shape = tuple(int(s) for s in data.shape)

    @classmethod
    def _from_coefficients(cls, coefficients, interpolation, device, mode,
                           cval):
        """A volume that holds ``coefficients`` as they are, with no
        prefilter (see :mod:`voltools_tpu_torch.convert`)."""
        sv = cls.__new__(cls)
        sv._configure(coefficients, interpolation, device, mode, cval)
        sv._autotune = None
        sv.data = pitched(_as_tensor(coefficients, sv._dev), copy=True)
        return sv

    def _resample(self, matrices: np.ndarray, out=None) -> torch.Tensor:
        return _resample(self.data, matrices, self.interpolation, self.mode,
                         self.cval, out=out)

    # ------------------------------------------------------------------ core

    def affine(self, transform_m: np.ndarray, profile: bool = False,
               output=None):
        """Apply a 4x4 pull-back matrix.  Per-call host-to-device traffic is
        the matrix only (reference ``volume.py:61-91``).

        ``output`` may be None (return numpy), a numpy array to fill
        (returns None), ``'device'`` (return a fresh CUDA tensor), or a
        float32 tensor of the volume's shape on the volume's device, which
        is written in place and returned: chain ``sv.affine(m, output=out)``
        for a sweep that allocates nothing."""
        with trace.span("api.affine"):
            if not isinstance(output, torch.Tensor):
                _check_output(output, self.device)
            if isinstance(output, np.ndarray):
                _check_shape(output.shape, self.shape)
            transform_m = np.asarray(transform_m, dtype=np.float32)
            timer = ProfileTimer(self._dev) if profile else None
            if timer:
                timer.__enter__()
            try:
                if isinstance(output, torch.Tensor):
                    return self._resample(transform_m, out=output)
                result = self._resample(transform_m)
                if isinstance(output, str):
                    return result
                return _finish(result.cpu().numpy(), output)
            finally:
                if timer:
                    timer.__exit__(None, None, None)

    def affine_batch(self, transform_ms: np.ndarray, profile: bool = False,
                     output=None):
        """Apply a stack of N matrices; returns (N, *shape).  Each launch
        resamples as many matrices as fit the output budget
        (``_BATCH_BYTES_BUDGET``); ``output='device'`` returns the whole
        stack as one CUDA tensor, so it must fit on the device."""
        _check_output(output, self.device)
        transform_ms = np.asarray(transform_ms, dtype=np.float32)
        if transform_ms.shape[:1] == (0,):
            # an empty sweep is an empty stack
            transform_ms = transform_ms.reshape(0, 4, 4)
        if transform_ms.ndim != 3 or transform_ms.shape[1:] != (4, 4):
            raise ValueError(
                f"expected an (N, 4, 4) stack, got {transform_ms.shape}")
        n = transform_ms.shape[0]
        full = (n,) + self.shape
        if isinstance(output, np.ndarray):
            _check_shape(output.shape, full)
        chunk = self.batch_chunk(self.shape)

        timer = ProfileTimer(self._dev) if profile else None
        if timer:
            timer.__enter__()
        try:
            if isinstance(output, str):
                stack = torch.empty(full, dtype=torch.float32,
                                    device=self._dev)
                for pos in range(0, n, chunk):
                    self._resample(transform_ms[pos:pos + chunk],
                                   out=stack[pos:pos + chunk])
                return stack
            # host return: the device holds one chunk of output at a time
            result_np = np.empty(full, np.float32)
            buf = torch.empty((min(chunk, n),) + self.shape,
                              dtype=torch.float32, device=self._dev)
            for pos in range(0, n, chunk):
                ms = transform_ms[pos:pos + chunk]
                result_np[pos:pos + len(ms)] = self._resample(
                    ms, out=buf[:len(ms)]).cpu().numpy()
            return _finish(result_np, output)
        finally:
            if timer:
                timer.__exit__(None, None, None)

    # ------------------------------------------------------------- transforms

    def transform(self, scale: Triple = None, shear: Triple = None,
                  rotation: Triple = None, rotation_units: str = "deg",
                  rotation_order: str = "rzxz",
                  translation: Triple = None, center: Triple = None,
                  profile: bool = False, output=None):
        if center is None:
            center = np.divide(np.subtract(self.shape, 1), 2, dtype=np.float32)
        m = transform_matrix(_as_triple(scale), _as_triple(shear),
                             _as_triple(rotation), rotation_units,
                             rotation_order, _as_triple(translation),
                             _as_triple(center))
        return self.affine(m, profile, output)

    def translate(self, translation, profile: bool = False, output=None):
        return self.affine(translation_matrix(translation), profile, output)

    def shear(self, coefficients: Triple, profile: bool = False, output=None):
        return self.affine(shear_matrix(_as_triple(coefficients)), profile,
                           output)

    def scale(self, coefficients: Triple, profile: bool = False, output=None):
        return self.affine(scale_matrix(_as_triple(coefficients)), profile,
                           output)

    def rotate(self, rotation, rotation_units: str = "deg",
               rotation_order: str = "rzxz", profile: bool = False,
               output=None):
        m = rotation_matrix(rotation=rotation, rotation_units=rotation_units,
                            rotation_order=rotation_order)
        return self.affine(m, profile, output)

"""Tilt-series projection: the cryo-ET forward model.

The port's counterpart of ``voltools_tpu/models/projections.py``: rotate a
resident volume through a series of orientations and integrate along an
axis to synthesise projections.  The rotations go through the planner
(:func:`voltools_tpu_torch.kernels.planner.route`), one envelope per chunk
of tilts, which gives each chunk to the faster kernel for it; the
integral is ``torch.sum`` over the projection axis, as the JAX package
leaves it to XLA.  The tilt stack is resampled in chunks of at most
``StaticVolume._BATCH_BYTES_BUDGET`` bytes before the sum (41 tilts of a
250^3 volume would be 2.56 GB).  The projector's resident volume is
pitched, as ``StaticVolume``'s (:mod:`..kernels.layout`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.layout import pitched
from ..ops.interpolation import (AVAILABLE_INTERPOLATIONS, MODES,
                                 needs_prefilter)
from ..ops.prefilter import bspline_prefilter
from ..ops.sampling import affine_sample
from ..transforms import _as_tensor, _device, _resample
from ..utils import trace, transform_matrix
from ..volume import StaticVolume


def _norm_axis(projection_axis) -> int:
    """Validate and normalise a (possibly negative, numpy-style) axis to
    {0, 1, 2}: the keep-axes computations compare it with range(3), so an
    unnormalised -3 or -2 would corrupt the geometry instead of failing."""
    axis = int(projection_axis)
    if not -3 <= axis <= 2:
        raise ValueError(
            f"projection_axis must be in [-3, 2], got {projection_axis!r}")
    return axis % 3


def project_stack(volume: torch.Tensor, matrices: np.ndarray,
                  interpolation: str, mode: str,
                  axis: int) -> torch.Tensor:
    """``volume`` resampled through each of the host ``matrices`` (N, 4, 4)
    onto its own grid and summed over ``axis``: (N, *projection shape).
    Each chunk of matrices is one kernel launch, planned as one envelope;
    the volume is sampled as it is (coefficients for a cubic mode)."""
    shape = tuple(volume.shape)
    n = len(matrices)
    proj_shape = tuple(s for a, s in enumerate(shape) if a != axis)
    result = torch.empty((n,) + proj_shape, dtype=torch.float32,
                         device=volume.device)
    chunk = StaticVolume.batch_chunk(shape)
    stack = torch.empty((min(chunk, n),) + shape, dtype=torch.float32,
                        device=volume.device)
    for pos in range(0, n, chunk):
        ms = matrices[pos:pos + chunk]
        rotated = _resample(volume, ms, interpolation, mode, 0.0,
                            out=stack[:len(ms)])
        with trace.span("project.sum", device=volume):
            torch.sum(rotated, dim=axis + 1, out=result[pos:pos + len(ms)])
    return result


def plain_project_stack(volume: torch.Tensor, matrices: np.ndarray,
                        interpolation: str, mode: str,
                        axis: int) -> torch.Tensor:
    """:func:`project_stack` through the kernels' plain version, one matrix
    at a time, on the volume's device: the reference the kernel path is
    held against."""
    if len(matrices) == 0:
        shape = tuple(s for a, s in enumerate(volume.shape) if a != axis)
        return volume.new_empty((0,) + shape)
    return torch.stack([
        torch.sum(affine_sample(volume, torch.as_tensor(
            m, dtype=torch.float32, device=volume.device), interpolation,
            mode, 0.0, prefiltered=True), dim=axis)
        for m in np.asarray(matrices, np.float32)])


class TiltSeriesProjector:
    """Projects a volume over a series of tilt angles.

    Parameters
    ----------
    data : (D, H, W) numpy array or tensor
    interpolation : any library interpolation mode; cubic modes that need
        it are prefiltered once, here
    projection_axis : axis integrated over (default 0, like summing slices)
    rotation_order : Euler convention for the tilt (default 'rzxz', as the
        reference examples use)
    device : 'cuda' (default), 'cuda:N', or 'cpu' for the plain versions
    mode : 'constant' or 'border' edges
    """

    def __init__(self, data, interpolation: str = "linear",
                 projection_axis: int = 0, rotation_order: str = "rzxz",
                 device: str = "cuda", mode: str = "constant"):
        self._configure(data, interpolation, projection_axis,
                        rotation_order, device, mode)
        vol = _as_tensor(data, self._dev)
        if needs_prefilter(interpolation):
            self.data = pitched(bspline_prefilter(vol))
        else:
            # private copy: later caller mutation must not change results
            self.data = pitched(vol, copy=True)

    def _configure(self, data, interpolation, projection_axis,
                   rotation_order, device, mode):
        if data.ndim != 3:
            raise ValueError("Expected a 3D array")
        if interpolation not in AVAILABLE_INTERPOLATIONS:
            raise ValueError(
                f"Interpolation must be one of {AVAILABLE_INTERPOLATIONS}")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self._dev = _device(device)
        self.device = device
        self.shape = tuple(int(s) for s in data.shape)
        self.projection_axis = _norm_axis(projection_axis)
        self.rotation_order = rotation_order
        self.interpolation = interpolation
        self.mode = mode
        self.center = np.divide(np.subtract(self.shape, 1), 2,
                                dtype=np.float32)

    @classmethod
    def _from_coefficients(cls, coefficients, interpolation, projection_axis,
                           rotation_order, device, mode):
        """A projector that holds ``coefficients`` as they are, with no
        prefilter (see :mod:`voltools_tpu_torch.convert`)."""
        proj = cls.__new__(cls)
        proj._configure(coefficients, interpolation, projection_axis,
                        rotation_order, device, mode)
        proj.data = pitched(_as_tensor(coefficients, proj._dev), copy=True)
        return proj

    def tilt_matrices(self, angles_deg: Sequence[float],
                      tilt_axis: int = 1) -> np.ndarray:
        """Rotation matrices for a single-axis tilt series about the
        center: the angle goes at position ``tilt_axis`` of the Euler
        triple."""
        ms = []
        for a in angles_deg:
            triple = [0.0, 0.0, 0.0]
            triple[tilt_axis] = float(a)
            ms.append(transform_matrix(rotation=triple,
                                       rotation_order=self.rotation_order,
                                       center=self.center))
        return np.stack(ms).astype(np.float32)

    def _project(self, matrices: np.ndarray) -> torch.Tensor:
        """Projections of the resident volume for ``matrices``, planned from
        these matrices on every call."""
        return project_stack(self.data, np.asarray(matrices, np.float32),
                             self.interpolation, self.mode,
                             self.projection_axis)

    def project(self, angles_deg: Sequence[float], tilt_axis: int = 1,
                output: Optional[str] = None):
        """The full tilt series: an (N, H', W') stack of projections, as
        numpy, or as the device tensor with ``output='device'``."""
        if output is not None and not (isinstance(output, str)
                                       and output == "device"):
            raise ValueError(
                f"output must be None or 'device', got {output!r}")
        result = self._project(self.tilt_matrices(angles_deg, tilt_axis))
        if output == "device":
            return result
        return result.cpu().numpy()

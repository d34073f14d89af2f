"""Carry a JAX-package ``StaticVolume``'s or ``TiltSeriesProjector``'s state
over to the port.

The JAX package's resident data is already converted (B-spline coefficients
for ``filt_bspline*``).  :func:`from_state` builds a port
:class:`~voltools_tpu_torch.volume.StaticVolume`, and
:func:`projector_from_state` a port
:class:`~voltools_tpu_torch.models.TiltSeriesProjector`, that hold the same
values and do not prefilter them again, so both packages resample the same
resident state.  They take plain numpy, and import nothing of JAX::

    sv_port = from_state(np.asarray(sv.data), sv.interpolation, sv.mode,
                         sv.cval, sv.shape, device="cuda")
    proj_port = projector_from_state(
        np.asarray(proj.data), proj.shape, proj.interpolation,
        proj.projection_axis, proj.rotation_order, proj._mode,
        device="cuda")
"""

from __future__ import annotations

import numpy as np

from .models import TiltSeriesProjector
from .volume import StaticVolume


def _state(data, shape) -> np.ndarray:
    data = np.asarray(data, dtype=np.float32)
    if shape is not None and tuple(shape) != data.shape:
        raise ValueError(
            f"state shape {tuple(shape)} does not match data {data.shape}")
    return data


def from_state(data, interpolation: str, mode: str = "constant",
               cval: float = 0.0, shape=None,
               device: str = "cuda") -> StaticVolume:
    """A port ``StaticVolume`` on ``device`` holding ``data`` (the resident,
    already prefiltered values) as they are.  ``shape``, when given, must
    match ``data``'s."""
    return StaticVolume._from_coefficients(_state(data, shape),
                                           interpolation, device, mode, cval)


def projector_from_state(data, shape, interpolation: str,
                         projection_axis: int = 0,
                         rotation_order: str = "rzxz",
                         mode: str = "constant",
                         device: str = "cuda") -> TiltSeriesProjector:
    """A port ``TiltSeriesProjector`` on ``device`` holding ``data`` (the
    resident, already prefiltered values) as they are.  ``shape`` must
    match ``data``'s."""
    return TiltSeriesProjector._from_coefficients(
        _state(data, shape), interpolation, projection_axis, rotation_order,
        device, mode)

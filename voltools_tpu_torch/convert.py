"""Carry a JAX-package ``StaticVolume``'s, ``TiltSeriesProjector``'s or
``ShardedVolume``'s state over to the port.

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
    shv_port = sharded_from_state(np.asarray(shv.data), shv.shape,
                                  shv.interpolation, shv.mode, shv.cval,
                                  mesh, shv.global_strategy)
"""

from __future__ import annotations

import numpy as np

from .models import TiltSeriesProjector
from .parallel import ShardedVolume
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


def sharded_from_state(data, shape, interpolation: str,
                       mode: str = "constant", cval: float = 0.0, mesh=None,
                       global_strategy: str = "stream") -> ShardedVolume:
    """A port ``ShardedVolume`` on ``mesh`` holding a JAX ``ShardedVolume``'s
    state: ``data`` is its padded, already prefiltered array, ``shape`` its
    true extent.  The planes past ``shape[0]`` are the JAX mesh's padding:
    they are dropped and the true extent padded anew for ``mesh`` by the
    same rule (mirror, or zeros for 'border'), so a mesh of any size
    serves."""
    data = np.asarray(data, dtype=np.float32)
    shape = tuple(int(s) for s in shape)
    if (data.ndim != 3 or len(shape) != 3 or data.shape[0] < shape[0]
            or data.shape[1:] != shape[1:]):
        raise ValueError(
            f"state {data.shape} does not hold a volume of shape {shape}")
    return ShardedVolume._from_coefficients(
        data[:shape[0]], shape, interpolation, mesh, mode, cval,
        global_strategy)

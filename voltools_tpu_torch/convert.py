"""Carry a JAX-package ``StaticVolume``'s state over to the port.

A ``voltools_tpu.StaticVolume`` holds its resident data already converted
(B-spline coefficients for ``filt_bspline*``).  :func:`from_state` builds a
port :class:`~voltools_tpu_torch.volume.StaticVolume` that holds the same
values and does not prefilter them again, so both packages resample the
same resident state.  It takes plain numpy, and imports nothing of JAX::

    sv_port = from_state(np.asarray(sv.data), sv.interpolation, sv.mode,
                         sv.cval, sv.shape, device="cuda")
"""

from __future__ import annotations

import numpy as np

from .volume import StaticVolume


def from_state(data, interpolation: str, mode: str = "constant",
               cval: float = 0.0, shape=None,
               device: str = "cuda") -> StaticVolume:
    """A port ``StaticVolume`` on ``device`` holding ``data`` (the resident,
    already prefiltered values) as they are.  ``shape``, when given, must
    match ``data``'s."""
    data = np.asarray(data, dtype=np.float32)
    if shape is not None and tuple(shape) != data.shape:
        raise ValueError(
            f"state shape {tuple(shape)} does not match data {data.shape}")
    return StaticVolume._from_coefficients(data, interpolation, device, mode,
                                           cval)

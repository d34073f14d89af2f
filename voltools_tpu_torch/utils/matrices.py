"""Affine / Euler-angle matrix construction (host-side, numpy).

Produces 4x4 *pull-back* matrices: they map an **output** voxel coordinate to
the **source** coordinate that should be sampled, which is the convention both
``scipy.ndimage.affine_transform`` and our device kernels consume.

Behavioral contract (matches the reference library, voltools v0.6.0):

* ``translation_matrix`` stores the *negated* translation, so that a positive
  user translation moves content in the positive axis direction
  (reference: ``voltools/utils/matrices.py:22-27``).
* ``rotation_matrix`` supports all 24 Gohlke-convention Euler axis orders
  ("sxyz" ... "rzyz") and negates the angles so rotations are counter-
  clockwise in the user's frame (reference: ``voltools/utils/matrices.py:30-90``).
* ``transform_matrix`` composes
  ``T(translation) @ T(-center) @ R @ Shear @ Scale @ T(center)`` and
  renormalises by ``m[3, 3]``
  (reference: ``voltools/utils/matrices.py:111-154``).

The Euler machinery follows the well-known conventions of Christoph Gohlke's
``transformations.py`` (also used by the reference), re-derived here from the
axis/parity/repetition/frame parameterisation.

This is the PyTorch port's own copy of ``voltools_tpu/utils/matrices.py``
(importing that module would import JAX through ``voltools_tpu``); only
:func:`rodrigues_matrix` differs, building a torch tensor so that autograd
flows through it.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Triple = Union[Tuple[float, float, float], Sequence[float], np.ndarray]

# Gohlke axis-sequence parameterisation: each 4-letter order name maps to
# (first axis, parity, repetition, frame).  's' = static/extrinsic frame,
# 'r' = rotating/intrinsic frame.
_AXES_SPEC = {}
for _frame, _frame_char in ((0, "s"), (1, "r")):
    for _first in range(3):
        for _parity in range(2):
            for _rep in range(2):
                _i = _first
                _j = (_first + _parity + 1) % 3
                _k = (_first + 2 - _parity) % 3
                _letters = "xyz"
                _name_axes = (_i, _j, _i if _rep else _k)
                _name = _frame_char + "".join(_letters[a] for a in _name_axes)
                if _frame:
                    # rotating-frame names are the reversed static names
                    _name = _frame_char + _name[1:][::-1]
                _AXES_SPEC[_name] = (_first, _parity, _rep, _frame)

AVAILABLE_ROTATIONS = sorted(_AXES_SPEC.keys())
AVAILABLE_UNITS = ["rad", "deg"]


def translation_matrix(translation: Triple, dtype=np.float32) -> np.ndarray:
    """4x4 pull-back matrix for a translation.

    The stored offset is negated: sampling ``src = out - t`` shifts content by
    ``+t`` in the output.
    """
    m = np.identity(4, dtype=dtype)
    m[:3, 3] = -np.asarray(translation, dtype=dtype)[:3]
    return m


def scale_matrix(coefficients: Triple, dtype=np.float32) -> np.ndarray:
    """4x4 pull-back matrix scaling each axis by the given coefficient."""
    m = np.identity(4, dtype=dtype)
    for a in range(3):
        m[a, a] = coefficients[a]
    return m


def shear_matrix(coefficients: Triple, dtype=np.float32) -> np.ndarray:
    """4x4 upper-triangular shear: coefficients couple (0,1), (0,2), (1,2).

    Layout matches the reference (``matrices.py:93-99``): ``m[0,1]=c0``,
    ``m[0,2]=c1``, ``m[1,2]=c2``.
    """
    m = np.identity(4, dtype=dtype)
    m[0, 1] = coefficients[0]
    m[0, 2] = coefficients[1]
    m[1, 2] = coefficients[2]
    return m


def rotation_matrix(rotation: Triple,
                    rotation_units: str = "deg",
                    rotation_order: str = "rzxz",
                    dtype=np.float32) -> np.ndarray:
    """4x4 rotation matrix for Euler angles in any of the 24 axis orders.

    Angles are negated internally ("CCW notation", reference
    ``matrices.py:47``) so the visible content rotates counter-clockwise for
    positive angles when the matrix is used as a pull-back map.
    """
    if rotation_units not in AVAILABLE_UNITS:
        raise ValueError(f"Rotation units must be one of {AVAILABLE_UNITS}")
    if rotation_order not in _AXES_SPEC:
        raise ValueError(f"Rotation order must be one of {AVAILABLE_ROTATIONS}")

    angles = np.asarray(rotation, dtype=np.float64)[:3]
    if rotation_units == "deg":
        angles = np.deg2rad(angles)
    ai, aj, ak = -angles  # CCW convention

    first, parity, rep, frame = _AXES_SPEC[rotation_order]
    i = first
    j = (first + parity + 1) % 3
    k = (first + 2 - parity) % 3

    if frame:
        ai, ak = ak, ai
    if parity:
        ai, aj, ak = -ai, -aj, -ak

    si, sj, sk = np.sin((ai, aj, ak))
    ci, cj, ck = np.cos((ai, aj, ak))
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk

    m = np.identity(4, dtype=np.float64)
    if rep:
        m[i, i], m[i, j], m[i, k] = cj, sj * si, sj * ci
        m[j, i], m[j, j], m[j, k] = sj * sk, -cj * ss + cc, -cj * cs - sc
        m[k, i], m[k, j], m[k, k] = -sj * ck, cj * sc + cs, cj * cc - ss
    else:
        m[i, i], m[i, j], m[i, k] = cj * ck, sj * sc - cs, sj * cc + ss
        m[j, i], m[j, j], m[j, k] = cj * sk, sj * ss + cc, sj * cs - sc
        m[k, i], m[k, j], m[k, k] = -sj, cj * si, cj * ci
    return m.astype(dtype)


def transform_matrix(scale: Triple = None,
                     shear: Triple = None,
                     rotation: Triple = None,
                     rotation_units: str = "deg",
                     rotation_order: str = "rzxz",
                     translation: Triple = None,
                     center: Triple = None,
                     dtype=np.float32) -> np.ndarray:
    """Compose a full transform matrix.

    Application order (on content): scale, shear, rotation, translation.
    With ``center`` given, scale/shear/rotation happen about that point.
    Composition (pull-back products, reference ``matrices.py:125-152``):
    ``T(translation) @ T(-center) @ R @ Shear @ Scale @ T(center)``.
    """
    m = np.identity(4, dtype=dtype)
    if translation is not None:
        m = m @ translation_matrix(translation, dtype)
    if center is not None:
        m = m @ translation_matrix([-c for c in np.asarray(center)], dtype)
    if rotation is not None:
        m = m @ rotation_matrix(rotation, rotation_units, rotation_order, dtype)
    if shear is not None:
        m = m @ shear_matrix(shear, dtype)
    if scale is not None:
        m = m @ scale_matrix(scale, dtype)
    if center is not None:
        m = m @ translation_matrix(center, dtype)
    m /= m[3, 3]
    return m


def rodrigues_matrix(w, center=None):
    """Differentiable pull-back rotation matrix from an axis-angle vector.

    ``w`` is a 3-vector (a torch tensor, possibly requiring grad): rotation
    by ``|w|`` radians about ``w/|w|`` via the Rodrigues formula, composed
    about ``center`` like :func:`transform_matrix`.  Sign convention: for a
    single-axis ``w`` this equals ``transform_matrix(rotation=-degrees(w),
    rotation_order='sxyz', center=center)``.  Returns a float32 (4, 4)
    tensor on ``w``'s device.
    """
    w = torch.as_tensor(w, dtype=torch.float32)
    theta = torch.sqrt(torch.sum(w * w) + 1e-24)
    k = w / theta
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    K = torch.stack([torch.stack([zero, -k[2], k[1]]),
                     torch.stack([k[2], zero, -k[0]]),
                     torch.stack([-k[1], k[0], zero])])
    eye3 = torch.eye(3, dtype=torch.float32, device=w.device)
    R = eye3 + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    t = torch.zeros(3, dtype=torch.float32, device=w.device)
    if center is not None:
        c = torch.as_tensor(center, dtype=torch.float32, device=w.device)
        # T(-c) @ R @ T(c) (pull-back composition, as transform_matrix)
        t = c - R @ c
    top = torch.cat([R, t[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32,
                          device=w.device)
    return torch.cat([top, bottom], dim=0)

"""Affine resampling: pull-back coordinate grids + interpolation (plain torch).

The port's counterpart of ``voltools_tpu/ops/sampling.py`` and the plain
version of the CUDA affine kernel
(:mod:`voltools_tpu_torch.kernels.affine_resample`).  All functions take the
4x4 **pull-back** matrix convention used by scipy and the reference:
``src = m[:3, :3] @ out + m[:3, 3]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .interpolation import sample


def affine_coords(out_shape: Tuple[int, int, int], matrix,
                  device=None) -> torch.Tensor:
    """Source coordinates for every output voxel; shape (3, *out_shape).

    Computed in float32 as ``m[a,0]*i + m[a,1]*j + m[a,2]*k + m[a,3]``,
    left to right with one rounding per operation: the CUDA kernel does
    the same arithmetic, so both floor() every coordinate alike."""
    m = torch.as_tensor(matrix, dtype=torch.float32, device=device)
    d0, d1, d2 = out_shape
    i = torch.arange(d0, dtype=torch.float32, device=m.device).view(-1, 1, 1)
    j = torch.arange(d1, dtype=torch.float32, device=m.device).view(1, -1, 1)
    k = torch.arange(d2, dtype=torch.float32, device=m.device).view(1, 1, -1)
    coords = [(m[a, 0] * i + m[a, 1] * j + m[a, 2] * k + m[a, 3]).expand(
        d0, d1, d2) for a in range(3)]
    return torch.stack(coords)


def affine_sample(volume, matrix, interpolation: str = "linear",
                  mode: str = "constant", cval: float = 0.0,
                  prefiltered: bool = False,
                  out_shape: Tuple[int, int, int] = None):
    """Resample ``volume`` through the pull-back ``matrix``.

    Differentiable with respect to the volume and the matrix."""
    volume = torch.as_tensor(volume, dtype=torch.float32)
    if out_shape is None:
        out_shape = tuple(volume.shape)
    coords = affine_coords(out_shape, matrix, device=volume.device)
    return sample(volume, coords, interpolation, mode, cval, prefiltered)


def map_coordinates(volume, coords, interpolation: str = "linear",
                    mode: str = "constant", cval: float = 0.0,
                    prefiltered: bool = False):
    """Sample a volume at arbitrary coordinates (scipy map_coordinates
    analogue with the library's interpolation modes).  ``coords``: (3, ...)."""
    volume = torch.as_tensor(volume, dtype=torch.float32)
    coords = torch.as_tensor(coords, dtype=torch.float32, device=volume.device)
    return sample(volume, coords, interpolation, mode, cval, prefiltered)


def affine_sample_batch(volume, matrices, interpolation: str = "linear",
                        mode: str = "constant", cval: float = 0.0,
                        prefiltered: bool = False,
                        out_shape: Tuple[int, int, int] = None):
    """Apply N pull-back matrices to one volume; returns (N, *out_shape)."""
    volume = torch.as_tensor(volume, dtype=torch.float32)
    matrices = torch.as_tensor(matrices, dtype=torch.float32,
                               device=volume.device)
    if out_shape is None:
        out_shape = tuple(volume.shape)
    if matrices.shape[0] == 0:
        return volume.new_empty((0,) + tuple(out_shape))
    return torch.stack([
        affine_sample(volume, m, interpolation, mode, cval, prefiltered,
                      out_shape) for m in matrices])

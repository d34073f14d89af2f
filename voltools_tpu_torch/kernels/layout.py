"""Row-pitched volumes: one resident buffer that both CUDA kernels read.

The slab kernel (:mod:`.affine_slab`) copies its boxes with TMA, which
needs every global stride to be a multiple of 16 bytes; a 250-float row is
1000 bytes.  A *pitched* volume keeps its (D, H, W) voxels in a (D, H, P)
buffer, P = W rounded up to ``ROW_ALIGN`` floats, and is the (D, H, W) view
of that buffer: strides (H * P, P, 1).  No padding column is ever used:
the kernels take the pitch and see W columns (TMA's tensor map has x extent
W, so the padding is out of range to it; the walk kernel's aligned float4
row loads may read padding and discard it), and the plain version reads
the view.  At 250^3 the padding costs 0.8% more memory.
"""

from __future__ import annotations

from typing import Optional

import torch

ROW_ALIGN = 4          # floats: 16 bytes, TMA's stride and row unit


def padded_width(width: int) -> int:
    """``width`` rounded up to a multiple of ``ROW_ALIGN``."""
    return -(-int(width) // ROW_ALIGN) * ROW_ALIGN


def _pitch_of(volume: torch.Tensor) -> Optional[int]:
    """The row pitch of a 3-D volume laid out as contiguous rows evenly
    spaced, (H * P, P, 1) with P >= W; ``None`` for any other layout."""
    if volume.is_contiguous():
        return int(volume.shape[2])
    d0, d1, d2 = volume.shape
    pitch = volume.stride(1)
    if volume.stride() != (d1 * pitch, pitch, 1) or pitch < d2:
        return None
    return int(pitch)


def row_pitch(volume: torch.Tensor) -> int:
    """The row pitch (floats) of a contiguous or pitched 3-D volume; any
    other layout raises."""
    pitch = _pitch_of(volume)
    if pitch is None:
        raise ValueError(
            f"volume must be contiguous or a row-pitched view (strides "
            f"(H * P, P, 1), P >= W), got strides {volume.stride()}")
    return pitch


def tma_ready(volume: torch.Tensor) -> bool:
    """Whether TMA can read ``volume`` as it lies: rows ``ROW_ALIGN``-float
    aligned and 16-byte aligned storage."""
    pitch = _pitch_of(volume)
    return (pitch is not None and pitch % ROW_ALIGN == 0
            and volume.data_ptr() % 16 == 0)


def pitched_empty(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """An uninitialised pitched volume of ``shape``; its padding is zero."""
    d0, d1, d2 = (int(s) for s in shape)
    buf = torch.empty((d0, d1, padded_width(d2)), dtype=dtype, device=device)
    buf[..., d2:].zero_()
    return buf[..., :d2]


def pitched(volume: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """``volume`` as a pitched volume: itself where TMA can already read it
    (and ``copy`` is false), else a pitched copy."""
    if tma_ready(volume) and not copy:
        return volume
    out = pitched_empty(volume.shape, volume.dtype, volume.device)
    return out.copy_(volume)

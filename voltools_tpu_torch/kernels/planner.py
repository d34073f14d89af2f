"""Tier the two CUDA affine kernels: the slab kernel where its box fits.

The port's counterpart of ``voltools_tpu/kernels/planner.py::choose_plan``
and of the window bound of ``pallas_affine.py::choose_variant`` /
``variant_covers``.  Both kernels compute the same function, bit for bit
(``csrc/resample_taps.cuh``), so the plan changes only where the taps are
read from:

* :mod:`.affine_slab` (the port of the TPU select-tree kernel) gives each
  CTA one output brick of ``BRICK`` voxels and stages the source box that
  the brick's taps can reach in shared memory.  It is taken when that box,
  for the envelope of every matrix in the launch, fits ``SMEM_BUDGET``.
* :mod:`.affine_resample` (the port of the TPU plane walk) gathers every
  tap from global memory and serves any matrix; it takes the rest.

The box rule generalises ``choose_variant``'s window span (``pallas_affine.py
:148``: sum of |a| * (tile - 1) + margin + 1) from the two row axes of an
(8 x 128) TPU tile to the three axes of a brick: for source axis r,
``span_r = max over matrices of sum_j |M[r, j]| * (t_j - 1)`` (float64), and
the kernel's box along r holds at most ``ceil(span_r) + taps + SLACK``
voxels, capped at the volume's extent.  ``SLACK`` is 3: one voxel below and
one above for a voxel inside the brick whose float coordinate floors one
lower or higher than the brick's corners (rounding at a knife edge, and the
'constant' cubic mirror row at n-1, which lands one row below
``floor - 1``), and one for ``ceil`` of a float span that exceeds the
float64 one by a rounding.

``BRICK`` and ``SMEM_BUDGET`` were fixed before the kernel first ran on a
card.  A (4, 8, 32) brick is 1024 output voxels for 256 threads (a warp per
row of 32 x, so stores are coalesced, and 4 voxels per thread), and its box
stays small for the matrices this kernel is for: a 41-tilt +-60 degree
envelope at 250^3 needs 24-59 KB (linear) and 33-77 KB (cubic), a random
rotation about 60 KB (linear) and 78 KB (cubic) at the median.  A budget of
96 KiB lets two CTAs share one SM's 227 KB, and takes every linear and
about three in four cubic single random rotations.

The TPU-only parts of ``choose_variant`` have no counterpart: the 36 axis
permutations, sublane drift and slop, row budgets, the unroll and fori
tiers, the VMEM budget and the cost model.  A CTA gathers from a 3-D box in
any orientation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..ops.interpolation import MODES, spline_order

BRICK = (4, 8, 32)          # output voxels per CTA along (z, y, x)
SMEM_BUDGET = 96 * 1024     # bytes of shared memory for one CTA's box
SLACK = 3


@dataclass(frozen=True)
class SlabPlan:
    """One launch of the slab kernel: its shared-memory box per CTA."""
    order: int                       # 1 trilinear, 3 cubic B-spline
    mode: str                        # 'constant' | 'border'
    vol_shape: Tuple[int, int, int]
    out_shape: Tuple[int, int, int]
    extents: Tuple[int, int, int]    # box voxels along source (z, y, x)

    @property
    def smem_bytes(self) -> int:
        return 4 * self.extents[0] * self.extents[1] * self.extents[2]


def _as_stack(matrices) -> np.ndarray:
    m = np.asarray(matrices, dtype=np.float64)
    if m.ndim == 2:
        m = m[None]
    if m.ndim != 3 or m.shape[1:] != (4, 4):
        raise ValueError(
            f"matrices must be (4, 4) or (N, 4, 4), got {m.shape}")
    return m


def slab_extents(matrices, vol_shape, order: int,
                 out_shape=None) -> Tuple[int, int, int]:
    """The box (voxels along source z, y, x) that every CTA of a slab launch
    over ``matrices`` needs, for ``order`` 1 or 3."""
    out_shape = tuple(vol_shape if out_shape is None else out_shape)
    m = _as_stack(matrices)
    if m.shape[0] == 0:
        return (1, 1, 1)
    brick = np.array([min(b, n) for b, n in zip(BRICK, out_shape)],
                     np.float64)
    spans = (np.abs(m[:, :3, :3]) @ (brick - 1.0)).max(axis=0)
    if not np.isfinite(spans).all():
        return tuple(int(n) for n in vol_shape)
    taps = 2 if order == 1 else 4
    return tuple(min(int(n), int(math.ceil(s)) + taps + SLACK)
                 for s, n in zip(spans, vol_shape))


def choose_plan(matrices, vol_shape, interpolation: str,
                mode: str = "constant",
                out_shape=None) -> Optional[SlabPlan]:
    """A :class:`SlabPlan` when the slab kernel can serve ``matrices`` (one
    (4, 4) matrix or an (N, 4, 4) envelope) in one launch, else ``None``
    (the walk port serves them)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    order = spline_order(interpolation)
    vol_shape = tuple(int(s) for s in vol_shape)
    out_shape = vol_shape if out_shape is None else tuple(
        int(s) for s in out_shape)
    plan = SlabPlan(order, mode, vol_shape, out_shape,
                    slab_extents(matrices, vol_shape, order, out_shape))
    return plan if plan.smem_bytes <= SMEM_BUDGET else None

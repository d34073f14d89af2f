"""Route each launch to the faster of the two CUDA affine kernels.

The port's counterpart of ``voltools_tpu/kernels/planner.py::choose_plan``
and of the window bound of ``pallas_affine.py::choose_variant`` /
``variant_covers``.  Both kernels compute the same function, bit for bit
(``csrc/resample_taps.cuh``), so the plan changes only where the taps are
read from, and how fast:

* :mod:`.affine_slab` (the port of the TPU select-tree kernel) gives each
  work item, one output brick of ``BRICK[order]`` voxels, a box of the
  source that TMA stages in shared memory, ``STAGES`` boxes in flight per
  CTA.
* :mod:`.affine_resample` (the port of the TPU plane walk) gathers every
  tap from global memory and serves any matrix.

Two rules decide, on the plan alone (the planner never times anything):

1. **The box rule** -- can the slab kernel take the launch?  The box of
   every brick, for the envelope of every matrix in the launch, must fit
   ``SMEM_BUDGET`` bytes (one of ``STAGES`` buffers; ``STAGES`` of them fit
   an SM's 227 KB) and TMA's largest box, ``MAX_BOX`` voxels along each
   axis.  It generalises ``choose_variant``'s window span
   (``pallas_affine.py:148``: sum of |a| * (tile - 1) + margin + 1) from the
   two row axes of an (8 x 128) TPU tile to the three axes of a brick: for
   source axis r, ``span_r = max over matrices of sum_j |M[r, j]| * (t_j -
   1)`` (float64), and the kernel's box along r holds ``ceil(span_r) + taps
   + SLACK`` voxels; along x, ``ROW_ALIGN - 1`` more, then rounded up to
   ``ROW_ALIGN``: TMA moves rows of a multiple of 16 bytes from 16-byte
   boundaries, so the kernel rounds a box's x origin down to a multiple of
   ``ROW_ALIGN`` floats.  ``SLACK`` is 3: one voxel below and one above for
   a voxel inside the brick whose float coordinate floors one lower or
   higher than the brick's corners (rounding at a knife edge, and the
   'constant' cubic mirror row at n-1, which lands one row below ``floor -
   1``), and one for ``ceil`` of a float span that exceeds the float64 one
   by a rounding.  The box is not capped at the volume: TMA fills what lies
   outside with zeros, which no tap reads.
2. **The speed rule** -- is the slab kernel the faster one?  Both kernels'
   times follow how far the taps of a brick spread in the source, which
   the box measures as source voxels per output voxel
   (``SlabPlan.box_per_voxel``).  Trilinear, the slab kernel's time is its
   box traffic from L2, which grows with the ratio, while the walk
   kernel's gathers stay cheap: the slab kernel is the faster where the
   ratio is small.  Cubic, the slab kernel's time is its compute, which
   the ratio hardly moves, while the walk kernel's 64 gathers a voxel slow
   down as they scatter: the slab kernel is the faster where the ratio is
   large.  So it takes a launch only where the ratio lies in
   ``SLAB_WINDOW[order]``.  The limits come from ``chip_smoke.py``'s times
   of both kernels on the 41-tilt series and random rotations at 250^3
   (PERF.md, "The planner's speed rule").

The TPU-only parts of ``choose_variant`` have no counterpart: the 36 axis
permutations, sublane drift and slop, row budgets, the unroll and fori
tiers, the VMEM budget and the cost model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..ops.interpolation import MODES, spline_order
from .layout import ROW_ALIGN, padded_width

# output voxels per work item along (z, y, x), per spline order (the
# kernel's Tile, csrc/affine_slab.cu)
BRICK = {1: (8, 8, 32), 3: (4, 8, 32)}
STAGES = 2                  # box buffers per CTA: one computed, one loading
SMEM_BUDGET = 112 * 1024    # bytes of one box buffer: STAGES fit 227 KB
MAX_BOX = 256               # TMA's largest box extent along an axis
SLACK = 3
# the speed rule: the box voxels per output voxel, (least, most), at which
# the slab kernel is the faster one, per spline order
SLAB_WINDOW = {1: (0.0, 8.0), 3: (12.0, math.inf)}


@dataclass(frozen=True)
class SlabPlan:
    """One launch of the slab kernel: the box every work item stages."""
    order: int                       # 1 trilinear, 3 cubic B-spline
    mode: str                        # 'constant' | 'border'
    vol_shape: Tuple[int, int, int]
    out_shape: Tuple[int, int, int]
    extents: Tuple[int, int, int]    # box voxels along source (z, y, x)

    @property
    def smem_bytes(self) -> int:
        """Bytes of one box buffer."""
        return 4 * self.extents[0] * self.extents[1] * self.extents[2]

    @property
    def box_per_voxel(self) -> float:
        """Source voxels a work item stages per output voxel it computes."""
        brick = [min(b, n) for b, n in zip(BRICK[self.order],
                                           self.out_shape)]
        return (self.extents[0] * self.extents[1] * self.extents[2]
                / (brick[0] * brick[1] * brick[2]))


class Route(NamedTuple):
    """The planner's choice: a plan for the slab kernel, or ``None`` for
    the walk kernel; the rule that decided ('box' or 'speed') and why."""
    plan: Optional[SlabPlan]
    rule: str
    reason: str


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
    """The box (voxels along source z, y, x; x a multiple of ``ROW_ALIGN``,
    with room for the x origin's rounding down) that every work item of a
    slab launch over ``matrices`` stages, for ``order`` 1 or 3.  Non-finite
    matrices read no tap; they get the volume's extents."""
    out_shape = tuple(vol_shape if out_shape is None else out_shape)
    m = _as_stack(matrices)
    if m.shape[0] == 0:
        return (1, 1, ROW_ALIGN)
    brick = np.array([min(b, n) for b, n in zip(BRICK[order], out_shape)],
                     np.float64)
    spans = (np.abs(m[:, :3, :3]) @ (brick - 1.0)).max(axis=0)
    if not np.isfinite(spans).all():
        extents = [int(n) for n in vol_shape]
    else:
        taps = 2 if order == 1 else 4
        extents = [int(math.ceil(s)) + taps + SLACK for s in spans]
        extents[2] += ROW_ALIGN - 1
    return (extents[0], extents[1], padded_width(extents[2]))


def _plan(matrices, vol_shape, interpolation, mode, out_shape) -> SlabPlan:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    order = spline_order(interpolation)
    vol_shape = tuple(int(s) for s in vol_shape)
    out_shape = vol_shape if out_shape is None else tuple(
        int(s) for s in out_shape)
    return SlabPlan(order, mode, vol_shape, out_shape,
                    slab_extents(matrices, vol_shape, order, out_shape))


def _box_refusal(plan: SlabPlan) -> Optional[str]:
    """Why the slab kernel cannot take ``plan``, or ``None`` if it can."""
    if plan.smem_bytes > SMEM_BUDGET:
        return (f"the slab box {plan.extents} needs {plan.smem_bytes} B, "
                f"over the {SMEM_BUDGET} B budget")
    if max(plan.extents) > MAX_BOX:
        return (f"the slab box {plan.extents} is over TMA's {MAX_BOX} "
                f"voxels along an axis")
    return None


def slab_plan(matrices, vol_shape, interpolation: str,
              mode: str = "constant",
              out_shape=None) -> Optional[SlabPlan]:
    """A :class:`SlabPlan` when the slab kernel can serve ``matrices`` (one
    (4, 4) matrix or an (N, 4, 4) envelope) in one launch -- the box rule
    alone -- else ``None``."""
    plan = _plan(matrices, vol_shape, interpolation, mode, out_shape)
    return plan if _box_refusal(plan) is None else None


def route(matrices, vol_shape, interpolation: str, mode: str = "constant",
          out_shape=None) -> Route:
    """Which kernel serves ``matrices`` in one launch, by the box rule and
    then the speed rule (see the module's docstring)."""
    plan = _plan(matrices, vol_shape, interpolation, mode, out_shape)
    refusal = _box_refusal(plan)
    if refusal is not None:
        return Route(None, "box", refusal)
    ratio = plan.box_per_voxel
    low, high = SLAB_WINDOW[plan.order]
    faster = low <= ratio <= high
    return Route(plan if faster else None, "speed",
                 f"the slab box {plan.extents} holds {ratio:.2f} source "
                 f"voxels per output voxel, {'in' if faster else 'outside'} "
                 f"the [{low}, {high}] where the slab kernel is the faster "
                 f"(order {plan.order})")


def choose_plan(matrices, vol_shape, interpolation: str,
                mode: str = "constant",
                out_shape=None) -> Optional[SlabPlan]:
    """The plan of :func:`route`: a :class:`SlabPlan` when the slab kernel
    takes the launch, else ``None`` (the walk kernel serves it)."""
    return route(matrices, vol_shape, interpolation, mode, out_shape).plan

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

Three rules decide, on the plan alone (the planner never times anything);
the row rule is tried first, after the speed rule's launch size:

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
   compute from shared memory where its boxes are small and its box
   traffic from L2, which grows with the ratio, where they are large; the
   walk kernel's stays flat.  The slab kernel takes a launch only inside
   ``SLAB_WINDOW[order]``: at least ``matrices`` matrices in the launch
   (its persistent grid pays its set-up once for them all) and at most
   ``box_per_voxel``; ``None`` where it takes none.  The window comes
   from ``chip_smoke.py``'s phase-7 times on an "NVIDIA H100 80GB HBM3,
   700.00 W" (PR 7; PERF.md "The planner's speed rule"), after the walk
   kernel's redesign (warp patches, several voxels a thread, the cubic
   interior fast path) and the slab kernel's brick-wide box test:
   trilinear, the slab kernel is the faster on the reconstruction's tilt
   series as the path launches it (chunks of 34 and 7 tilts at 4.39 box
   voxels per output voxel: 0.1046 against 0.1076 ms per matrix), level
   with the walk kernel one matrix a launch at 3.8-4.5, and 1.1-3x slower
   above; cubic, whose walk kernel runs on the fast path, it is slower at
   every box size (1.4-1.5x on the tilt series).  A launch of fewer
   matrices than the window's, or of an order it leaves out, is decided
   before any plan is made: the planner runs on every call.
3. **The row rule** -- does every matrix leave the row axis alone?  Where
   a trilinear launch that the speed rule's size admits (``matrices`` or
   more) has every matrix's row 2 equal to (0, 0, 1, 0) and column 2 of
   rows 0 and 1 zero (:func:`_leaves_alone` of ``ROW_AXIS``), each output
   row is a weighted sum of four whole source rows: the slab kernel takes
   it on its row path (``SlabPlan.rows``), which stages no box, so the
   box rule and the box size do not apply.  A single-axis tilt series
   about array axis 2 ('rzxz' with the angle at position 0) is such a
   launch.  The route's rule is then 'rows'.  The plan keeps the box of
   the general kernel, which the row path never stages and does not
   check.  On a finite volume the row path is the general kernel bit for
   bit; an Inf or a NaN voxel turns its x - 1 neighbour into NaN in the
   general kernel (its x lerp's weight 0 times the voxel), not here.

The TPU-only parts of ``choose_variant`` have no counterpart: the 36 axis
permutations, sublane drift and slop, row budgets, the unroll and fori
tiers, the VMEM budget and the cost model.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..ops.interpolation import MODES, spline_order
from .affine_resample import DEEP_PATCH, FLAT_PATCH
from .layout import ROW_ALIGN, padded_width

# output voxels per work item along (z, y, x), per spline order (the
# kernel's Tile, csrc/affine_slab.cu)
BRICK = {1: (8, 8, 32), 3: (4, 8, 32)}
STAGES = 2                  # box buffers per CTA: one computed, one loading
SMEM_BUDGET = 112 * 1024    # bytes of one box buffer: STAGES fit 227 KB
MAX_BOX = 256               # TMA's largest box extent along an axis
SLACK = 3
ROW_AXIS = 2                # the row path's untouched axis: rows of x


class SlabWindow(NamedTuple):
    """Where the speed rule gives the slab kernel a launch of one spline
    order: at least ``matrices`` matrices in the launch and at most
    ``box_per_voxel`` source voxels staged per output voxel."""
    matrices: int
    box_per_voxel: float


# the speed rule, per spline order; None where the slab kernel takes no
# launch
SLAB_WINDOW = {1: SlabWindow(2, 4.5), 3: None}


@dataclass(frozen=True)
class SlabPlan:
    """One launch of the slab kernel: the box every work item stages."""
    order: int                       # 1 trilinear, 3 cubic B-spline
    mode: str                        # 'constant' | 'border'
    vol_shape: Tuple[int, int, int]
    out_shape: Tuple[int, int, int]
    extents: Tuple[int, int, int]    # box voxels along source (z, y, x)
    rows: bool = False               # the row path: no box is staged

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
    the walk kernel; the rule that decided ('box', 'speed' or 'rows') and
    why."""
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


def _leaves_alone(matrices, r: int) -> bool:
    """Whether every matrix has row ``r`` equal to ``e_r`` and column
    ``r`` of the other two rows 0, in exact float32 equality: a sample's
    coordinate along ``r`` is then the output index itself and the other
    two do not depend on it."""
    m = np.asarray(matrices, np.float32).reshape(-1, 4, 4)
    others = [a for a in range(3) if a != r]
    return bool(np.all(m[:, r] == np.eye(4, dtype=np.float32)[r])
                and np.all(m[:, others, r] == 0))


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
    """A :class:`SlabPlan` of the general kernel when the slab kernel can
    serve ``matrices`` (one (4, 4) matrix or an (N, 4, 4) envelope) in one
    launch -- the box rule alone -- else ``None``.  Only :func:`route`
    gives row plans."""
    plan = _plan(matrices, vol_shape, interpolation, mode, out_shape)
    return plan if _box_refusal(plan) is None else None


def route(matrices, vol_shape, interpolation: str, mode: str = "constant",
          out_shape=None) -> Route:
    """Which kernel serves ``matrices`` in one launch, by the box rule and
    then the speed rule (see the module's docstring).  Where the slab
    kernel is never the faster for the order, no plan is made."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    order = spline_order(interpolation)
    window = SLAB_WINDOW[order]
    if window is None:
        return Route(None, "speed",
                     f"the walk kernel is the faster at every box size "
                     f"(order {order})")
    n = _as_stack(matrices).shape[0]
    if n < window.matrices:
        return Route(None, "speed",
                     f"{n} matrices a launch, outside the slab kernel's "
                     f"window of at least {window.matrices} (order {order})")
    plan = _plan(matrices, vol_shape, interpolation, mode, out_shape)
    if order == 1 and _leaves_alone(matrices, ROW_AXIS):
        return Route(dataclasses.replace(plan, rows=True), "rows",
                     f"{n} matrices that leave the row axis alone: the "
                     f"slab kernel's row path, four source rows an output "
                     f"row, no box (order {order}); the general kernel "
                     f"bit for bit on a finite volume")
    refusal = _box_refusal(plan)
    if refusal is not None:
        return Route(None, "box", refusal)
    ratio = plan.box_per_voxel
    taken = ratio <= window.box_per_voxel
    return Route(plan if taken else None, "speed",
                 f"{n} matrices, the slab box {plan.extents} holding "
                 f"{ratio:.2f} source voxels per output voxel: "
                 f"{'inside' if taken else 'outside'} the slab kernel's "
                 f"window, at least {window.matrices} matrices and at most "
                 f"{window.box_per_voxel} (order {order})")


def choose_plan(matrices, vol_shape, interpolation: str,
                mode: str = "constant",
                out_shape=None) -> Optional[SlabPlan]:
    """The plan of :func:`route`: a :class:`SlabPlan` when the slab kernel
    takes the launch, else ``None`` (the walk kernel serves it)."""
    return route(matrices, vol_shape, interpolation, mode, out_shape).plan


def _rows(rows, patch) -> float:
    """(span_z + 1) * (span_y + 1) of one matrix's |M[:2, :3]| ``rows``
    (lists of floats) for ``patch``."""
    (z0, z1, z2), (y0, y1, y2) = rows
    pz, py, px = (p - 1 for p in patch)
    return (z0 * pz + z1 * py + z2 * px + 1.0) * (
        y0 * pz + y1 * py + y2 * px + 1.0)


def patch_rows(matrices, patch) -> float:
    """The source rows that the image of one warp's ``patch`` (32 output
    voxels along z, y, x) spans, summed over ``matrices``: per matrix
    (span_z + 1) * (span_y + 1), span_a the sum over output axes j of
    |M[a, j]| * (patch_j - 1).  Rows, not columns, because a warp's load of
    one tap is served a 128-byte line at a time and a row's taps lie in
    one or two lines."""
    return sum(_rows(rows, patch) for rows in
               np.abs(_as_stack(matrices)[:, :2, :3]).tolist())


def walk_patch(matrices):
    """The warp patch of a walk-kernel launch over ``matrices``: the deep
    one (``DEEP_PATCH``, (2, 2, 8)) where its images span fewer source
    rows than the flat one's (``FLAT_PATCH``, (1, 4, 8)), else the flat
    one.  A tilt about the output's z axis keeps a flat patch in one source
    plane; a rotation that mixes all three axes does better with the deep
    one (tools/walk_variants.py, PERF.md).  Non-finite matrices take the
    flat patch.  In Python floats: the planner calls it on every launch."""
    deep = flat = 0.0
    for rows in np.abs(_as_stack(matrices)[:, :2, :3]).tolist():
        deep += _rows(rows, DEEP_PATCH)
        flat += _rows(rows, FLAT_PATCH)
    return DEEP_PATCH if deep < flat else FLAT_PATCH

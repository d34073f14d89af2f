"""The least work of each function the cells time, at the H100's peaks.

Each count is the work of the *function*, whatever kernel computes it:
every input byte read once, every output byte written once, and the
floating-point operations the arithmetic needs at the least (an FMA counts
2).  A function's least time is the larger of its bytes over the memory
rate and its operations over the fp32 rate (``peaks.json``); a kernel's
roofline share is that time over the kernel's measured time.

Frozen from ``chip_smoke.py`` (``FLOPS_INSIDE``/``FLOPS_OUTSIDE`` :244-248,
``BACKPROJECT_FLOPS`` :294, ``backproject_bound_ms`` :466,
``inside_voxels`` :579, ``bound_ms`` :596), rewritten to take host
matrices and to compute the source coordinates itself.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
HBM_BYTES_PER_S = PEAKS["hbm_bytes_per_s"]
FP32_FLOPS = PEAKS["fp32_flops"]

# an affine resample, per output voxel whose source point lies inside the
# volume: 3 coordinates of 3 FMAs (18), 3 fractions, the weights (1 per
# axis for linear, 14 for cubic) and a separable contraction of
# k^3 + k^2 + k FMAs (14 linear, 84 cubic); outside, the coordinates only
FLOPS_INSIDE = {1: 18 + 3 + 3 * 1 + 2 * 14, 3: 18 + 3 + 3 * 14 + 2 * 84}
FLOPS_OUTSIDE = 18
# a back-projection, per output voxel a tilt: row-gather (a single-axis
# series) a lerp (3) and the sum (1), the row coordinate shared by a line;
# general: two coordinates by one FMA each (4), two fractions (2), three
# lerps (9) and the sum (1)
BACKPROJECT_FLOPS = {True: 4, False: 16}


def least_ms(n_bytes: float, flops: float):
    """(least ms, 'bytes' or 'operations', whichever bounds it)."""
    tb = n_bytes / HBM_BYTES_PER_S
    to = flops / FP32_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def inside_voxels(shape, matrix, mode: str = "constant",
                  device=None) -> int:
    """Output voxels of ``shape`` whose source point lies inside a volume
    of ``shape`` by ``mode``'s test ('constant': [0, n - 1] on every axis;
    'border': more than half a voxel inside), from float32 coordinates
    ``((m0 i + m1 j) + m2 k) + m3``, one rounding an operation."""
    m = torch.as_tensor(np.asarray(matrix, np.float32), device=device)
    d0, d1, d2 = (int(s) for s in shape)
    i = torch.arange(d0, dtype=torch.float32, device=device).view(-1, 1, 1)
    j = torch.arange(d1, dtype=torch.float32, device=device).view(1, -1, 1)
    k = torch.arange(d2, dtype=torch.float32, device=device).view(1, 1, -1)
    inside = torch.ones((d0, d1, d2), dtype=torch.bool, device=device)
    for a, n in enumerate((d0, d1, d2)):
        s = ((m[a, 0] * i + m[a, 1] * j) + m[a, 2] * k) + m[a, 3]
        if mode == "constant":
            inside &= (s >= 0) & (s <= n - 1)
        else:
            inside &= (s > -0.5) & (s < n - 0.5)
    return int(inside.sum())


def resample_launch_ms(order: int, in_shape, out_shape, inside):
    """Least time of one launch of an affine resample of a volume of
    ``in_shape`` through ``len(inside)`` matrices onto ``out_shape``,
    ``inside[m]`` output voxels of matrix m inside the source: the source
    read once, every output written once, FLOPS_INSIDE at each inside
    voxel and FLOPS_OUTSIDE at the others.  Returns (ms, bound)."""
    vin = int(np.prod(in_shape))
    vout = int(np.prod(out_shape))
    n_bytes = 4.0 * (vin + len(inside) * vout)
    flops = sum(FLOPS_INSIDE[order] * c + FLOPS_OUTSIDE * (vout - c)
                for c in inside)
    return least_ms(n_bytes, flops)


def backproject_launch_ms(n: int, out_shape, proj_shape, rowgather: bool):
    """Least time of one back-projection of ``n`` projections of
    ``proj_shape`` into ``out_shape``: the projections read once, the
    volume written once, BACKPROJECT_FLOPS a voxel a tilt.  Returns
    (ms, bound)."""
    vout = int(np.prod(out_shape))
    n_bytes = 4.0 * (vout + n * int(np.prod(proj_shape)))
    flops = BACKPROJECT_FLOPS[bool(rowgather)] * n * vout
    return least_ms(n_bytes, flops)

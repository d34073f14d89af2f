"""The least work of one orientation of template matching against a
tomogram of ``shape`` (``voltools_tpu_torch.TemplateMatcher``), whatever
computes it: the tomogram's spectrum (complex64 on the ``rfftn`` grid)
and its float32 ``1 / sigma`` map read once, the float32 score map and the
int32 index map read and written once, and the two tomogram-sized
transforms' ``2.5 N log2 N`` operations each.  The template's rotation,
wedge and normalisation at its small box are left out: at a 48^3 box they
are under a thousandth of these bytes."""

from __future__ import annotations

import math

from portbench.roofline import least_ms


def orientation_work(shape):
    """(bytes, operations) of one orientation."""
    n = math.prod(int(s) for s in shape)
    spectrum = int(shape[0]) * int(shape[1]) * (int(shape[2]) // 2 + 1)
    n_bytes = 8.0 * spectrum + 4.0 * n + 2 * (4.0 * n + 4.0 * n)
    flops = 2 * 2.5 * n * math.log2(n)
    return n_bytes, flops


def orientation_ms(shape):
    """(least ms of one orientation, 'bytes' or 'operations')."""
    return least_ms(*orientation_work(shape))

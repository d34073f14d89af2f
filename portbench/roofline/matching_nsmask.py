"""The least work of one orientation of template matching under a mask
that is not spherical, against a tomogram of ``shape``
(``voltools_tpu_torch.TemplateMatcher`` on its non-spherical path),
whatever computes it: the spectra of the tomogram and of its square
(complex64 on the ``rfftn`` grid) read once, the float32 score map and
the int32 index map read and written once, and five tomogram-sized
transforms' ``2.5 N log2 N`` operations each (the template's forward and
the correlation's inverse, the rotated mask's forward and the inverses
of its two correlations).  No ``1 / sigma`` map is read: the local
statistics are the orientation's own.  The template's and the mask's
rotation, the wedge and the normalisation at the small box are left out,
as :mod:`portbench.roofline.matching` leaves them out."""

from __future__ import annotations

import math

from portbench.roofline import least_ms

TRANSFORMS = 5


def orientation_work(shape):
    """(bytes, operations) of one orientation."""
    n = math.prod(int(s) for s in shape)
    spectrum = int(shape[0]) * int(shape[1]) * (int(shape[2]) // 2 + 1)
    n_bytes = 2 * 8.0 * spectrum + 2 * (4.0 * n + 4.0 * n)
    flops = TRANSFORMS * 2.5 * n * math.log2(n)
    return n_bytes, flops


def orientation_ms(shape):
    """(least ms of one orientation, 'bytes' or 'operations')."""
    return least_ms(*orientation_work(shape))

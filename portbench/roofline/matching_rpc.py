"""The least work of one orientation of template matching with the
random-phase correction against a tomogram of ``shape``
(``voltools_tpu_torch.TemplateMatcher`` with ``random_phase_correction``,
under a spherical mask), whatever computes it: the tomogram's spectrum
(complex64 on the ``rfftn`` grid) and its float32 ``1 / sigma`` map read
once, the float32 score map, the int32 index map and the float32 noise
map read and written once, and four tomogram-sized transforms' ``2.5 N
log2 N`` operations each (the template's and the noise template's
forward and inverse).  The two templates' rotation, wedge and
normalisation at the small box are left out, as
:mod:`portbench.roofline.matching` leaves them out.

The noise map's update alone (the update kernel's max-only entry) must
read the noise correlation, the ``1 / sigma`` map and the noise map once,
12 bytes a voxel; in a long sweep the writes vanish, as few voxels gain a
new best."""

from __future__ import annotations

import math

from portbench.roofline import least_ms

TRANSFORMS = 4


def orientation_work(shape):
    """(bytes, operations) of one orientation."""
    n = math.prod(int(s) for s in shape)
    spectrum = int(shape[0]) * int(shape[1]) * (int(shape[2]) // 2 + 1)
    n_bytes = 8.0 * spectrum + 4.0 * n + 2 * (4.0 * n + 4.0 * n + 4.0 * n)
    flops = TRANSFORMS * 2.5 * n * math.log2(n)
    return n_bytes, flops


def orientation_ms(shape):
    """(least ms of one orientation, 'bytes' or 'operations')."""
    return least_ms(*orientation_work(shape))


def noise_update_ms(shape):
    """(least ms of one update of the noise map, 'bytes')."""
    n = math.prod(int(s) for s in shape)
    return least_ms(12.0 * n, 0.0)

from .interpolation import (
    AVAILABLE_INTERPOLATIONS,
    cubic_bspline_weights,
    needs_prefilter,
    sample,
    sample_cubic,
    sample_linear,
    spline_order,
)
from .prefilter import (
    LAMBDA,
    POLE,
    bspline_prefilter,
    prefilter_fir,
    prefilter_scan,
)
from .sampling import (
    affine_coords,
    affine_sample,
    affine_sample_batch,
    map_coordinates,
)

__all__ = [
    "AVAILABLE_INTERPOLATIONS",
    "cubic_bspline_weights",
    "needs_prefilter",
    "sample",
    "sample_cubic",
    "sample_linear",
    "spline_order",
    "LAMBDA",
    "POLE",
    "bspline_prefilter",
    "prefilter_fir",
    "prefilter_scan",
    "affine_coords",
    "affine_sample",
    "affine_sample_batch",
    "map_coordinates",
]

from .projections import TiltSeriesProjector
from .reconstruction import ramp_filter, sirt_reconstruct, wbp_reconstruct

__all__ = ["TiltSeriesProjector", "ramp_filter", "sirt_reconstruct",
           "wbp_reconstruct"]

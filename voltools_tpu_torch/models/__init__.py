from .projections import TiltSeriesProjector
from .reconstruction import ramp_filter, sirt_reconstruct, wbp_reconstruct
from .registration import (RegistrationResult, phase_cross_correlation,
                           register)

__all__ = ["TiltSeriesProjector", "ramp_filter", "sirt_reconstruct",
           "wbp_reconstruct", "phase_cross_correlation", "register",
           "RegistrationResult"]

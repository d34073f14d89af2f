from .matrices import (
    AVAILABLE_ROTATIONS,
    AVAILABLE_UNITS,
    rodrigues_matrix,
    rotation_matrix,
    scale_matrix,
    shear_matrix,
    transform_matrix,
    translation_matrix,
)
from .general import (
    ProfileTimer,
    compute_post_transform_dimensions,
    full_fp32_matmul,
    get_available_devices,
    resolve_device,
)

__all__ = [
    "AVAILABLE_ROTATIONS",
    "AVAILABLE_UNITS",
    "rodrigues_matrix",
    "rotation_matrix",
    "scale_matrix",
    "shear_matrix",
    "transform_matrix",
    "translation_matrix",
    "ProfileTimer",
    "compute_post_transform_dimensions",
    "full_fp32_matmul",
    "get_available_devices",
    "resolve_device",
]

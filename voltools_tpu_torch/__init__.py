"""voltools_tpu_torch -- the PyTorch/CUDA port of ``voltools_tpu``.

3-D affine transforms of volumes on an NVIDIA GPU: five interpolation modes
(trilinear + four cubic B-spline variants), ``'constant'`` and ``'border'``
edges, a one-shot functional API and a device-resident ``StaticVolume`` with
batched transforms.  The resampling runs in a hand-written CUDA kernel
(``csrc/affine_resample.cu``), built with ``nvcc`` at first use; the plain
torch versions serve ``device='cpu'``.

The package imports torch, numpy and scipy only -- never JAX -- and probes
no device at import.
"""

from .transforms import (
    PerformanceFallbackWarning,
    affine,
    last_dispatch,
    rotate,
    scale,
    shear,
    transform,
    translate,
)
from .ops.interpolation import AVAILABLE_INTERPOLATIONS
from .volume import StaticVolume
from . import ops, utils


def __getattr__(name):
    # lazy: the device list is read when asked for, never at import
    if name == "AVAILABLE_DEVICES":
        return utils.get_available_devices()
    raise AttributeError(name)


__all__ = [
    "transform",
    "affine",
    "rotate",
    "scale",
    "shear",
    "translate",
    "StaticVolume",
    "PerformanceFallbackWarning",
    "last_dispatch",
    "AVAILABLE_INTERPOLATIONS",
    "AVAILABLE_DEVICES",
    "ops",
    "utils",
]

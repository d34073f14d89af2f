"""voltools_tpu_torch -- the PyTorch/CUDA port of ``voltools_tpu``.

3-D affine transforms of volumes on an NVIDIA GPU: five interpolation modes
(trilinear + four cubic B-spline variants), ``'constant'`` and ``'border'``
edges, a one-shot functional API, a device-resident ``StaticVolume`` with
batched transforms, the tilt-series models (``models``: projector,
weighted back-projection, SIRT, each reconstruction also over a device
mesh), template matching (``TemplateMatcher``) and registration
(``models.phase_cross_correlation``, ``models.register`` and its
``models.RegistrationResult``), and several
devices (``parallel``: a ``Mesh`` of devices, which may repeat, a
``ShardedVolume`` sharded along z and ``sharded_affine_batch``).  The resampling runs in two hand-written
CUDA kernels that compute the same function: ``csrc/affine_slab.cu``
stages each output brick's source box in shared memory with TMA,
``csrc/affine_resample.cu`` gathers from global memory, and the planner
gives each launch to the faster of the two for its matrices
(``kernels/planner.py``).  Both are
built with ``nvcc`` at first use; the plain torch versions serve
``device='cpu'``, and ``affine(..., device='cpu', cpu_backend='scipy' |
'native')`` the JAX package's CPU backends (``native``: a C++ resampler
built with ``g++`` at first use).

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
from . import models, ops, parallel, utils
# the JAX package has no template matching: importable here, and kept out
# of ``__all__``, which holds the JAX package's names and subpackages
from .models import TemplateMatcher  # noqa: F401

__version__ = "0.6.0"


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
    "models",
    "ops",
    "parallel",
    "utils",
    "__version__",
]

"""Template matching's local sigma map under a rotated mask: CUDA for CUDA
tensors, plain torch on the CPU.

:func:`match_sigma` takes the rotated mask's two moments, their spectra
already inverted along z and y (complex128, (Z, Y, X // 2 + 1)): ``N n``
times the local mean and mean square, ``N`` the tomogram's voxels and ``n``
the mask's weight.  It returns the orientation's ``1 / (N n sigma)`` map,
float32, (Z, Y, X) contiguous: ``w = N n * mean_sq' - mean'^2`` in float64
after the C2R along x of both, rounded to float32, then ``rsqrt(w)``, 0
where ``w`` is at most ``floor`` times the map's largest ``max(w, 0)``.  No
TPU kernel stands behind it (the JAX package has no template matching); it
replaces the C2R and the map's plain passes of ``TemplateMatcher``, which
stay here as its plain version, :func:`plain_match_sigma`.  For CUDA
tensors it launches ``csrc/match_sigma.cu`` (built by ``nvcc`` at first
use, see :mod:`._build`) on the current stream without synchronising: one
launch takes the C2R, ``w``, its float32 map and its largest value (a
device word, so ``n`` and the floor are never read on the host), and one
launch of its finish entry takes the floor and ``rsqrt`` in place.  For CPU
tensors it runs the plain version.  A CUDA tensor never falls back to the
plain version: the launches succeed or the call raises.

The kernel takes any width ``X`` from 1 to ``MAX_WIDTH`` (:func:`supported`,
:func:`design`): the C2R of a row is one complex inverse FFT of ``X / 2``
points for an even ``X`` (of ``X`` points of the Hermitian row for an odd
one), for a power of two from ``REGISTER_WIDTHS[0]`` to
``REGISTER_WIDTHS[1]`` in the passes of radix 16 of ``match_zpass``'s
register design, for any other width in the Stockham passes in shared
memory of its shared-memory design, or, where the points have a prime
factor above ``match_zpass.MAX_DIRECT``, through Bluestein's convolution
with :func:`match_zpass.chirp_tables` of the points.  Its numbers differ
from the plain version's by the order of rounding inside the row's
transform and ``rsqrt``'s last place.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import match_zpass as zpass

NAME = "match_sigma"
FINISH_NAME = "match_sigma_finish"
SOURCE = "voltools_tpu_torch/csrc/match_sigma.cu"
# the widths the kernel takes, and the powers of two its register design
# takes (X / 2 from 64 to 1024)
MAX_WIDTH = 2048
REGISTER_WIDTHS = (128, 2048)

# match_sigma_launch's parameters
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p,                   # the moments
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # their strides
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # Z, Y, X
    ctypes.c_void_p,                                    # n
    ctypes.c_void_p, ctypes.c_void_p,                   # the map, its largest
    ctypes.c_void_p,                                    # Bluestein's tables
    ctypes.c_void_p,                                    # stream
]

# match_sigma_finish_launch's parameters
FINISH_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong,                 # the map, its voxels
    ctypes.c_void_p, ctypes.c_float,                    # its largest, floor
    ctypes.c_void_p,                                    # stream
]

LIBRARY = _build.Library(NAME, {"match_sigma_launch": ARGTYPES,
                                "match_sigma_finish_launch": FINISH_ARGTYPES})
_LAUNCH = LIBRARY.launcher("match_sigma_launch", NAME)
_FINISH = LIBRARY.launcher("match_sigma_finish_launch", FINISH_NAME)


def supported(width: int, device) -> bool:
    """Whether the kernel serves a tomogram ``width`` along x on
    ``device``: a CUDA device and 1 to ``MAX_WIDTH``."""
    return torch.device(device).type == "cuda" and 1 <= width <= MAX_WIDTH


def points(width: int) -> int:
    """The points of the complex FFT that takes a row's C2R: ``width / 2``
    for an even ``width``, ``width`` for an odd one."""
    return width // 2 if width % 2 == 0 else width


def design(width: int) -> str:
    """The kernel's design for ``width``: ``'registers'`` (a power of two
    from ``REGISTER_WIDTHS[0]`` to ``REGISTER_WIDTHS[1]``), ``'bluestein'``
    (the shared-memory design through Bluestein's convolution) or
    ``'shared'``."""
    if (REGISTER_WIDTHS[0] <= width <= REGISTER_WIDTHS[1]
            and width & (width - 1) == 0):
        return "registers"
    return "bluestein" if zpass.bluestein_length(points(width)) else "shared"


def plain_match_sigma(mean: torch.Tensor, mean_sq: torch.Tensor,
                      n: torch.Tensor, width: int,
                      floor: float) -> torch.Tensor:
    """The kernel's plain version, the torch passes it replaces: the C2R
    along x of both moments, ``w = N n * mean_sq' - mean'^2`` (the scale,
    then ``addcmul_``), the float32 copy, the floor against ``w``'s largest
    value, ``rsqrt_`` and ``masked_fill_``."""
    mean = torch.fft.irfft(mean, n=width, dim=2, norm="forward")
    w = torch.fft.irfft(mean_sq, n=width, dim=2, norm="forward")
    w.mul_(mean.numel() * n.double()).addcmul_(mean, mean, value=-1.0)
    del mean
    w = w.to(torch.float32)
    low = w <= floor * w.max().clamp_min(0.0)
    return w.rsqrt_().masked_fill_(low, 0.0)


def _check(mean, mean_sq, n, width) -> None:
    for name, t in (("mean", mean), ("mean_sq", mean_sq), ("n", n)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        if t.device != mean.device:
            raise ValueError(f"{name} is on {t.device}, mean on "
                             f"{mean.device}")
    for name, t in (("mean", mean), ("mean_sq", mean_sq)):
        if t.dtype != torch.complex128:
            raise ValueError(f"{name} must be complex128, got {t.dtype}")
        if t.ndim != 3 or min(t.stride()) < 0:
            raise ValueError(f"{name} must be 3-D with strides of 0 or more")
    if mean.shape != mean_sq.shape or mean.stride() != mean_sq.stride():
        raise ValueError("the moments must share one shape and one layout")
    if mean.shape[2] != width // 2 + 1 or width < 1:
        raise ValueError(f"a width of {width} takes {width // 2 + 1} "
                         f"entries along x, the moments have "
                         f"{mean.shape[2]}")
    if n.dtype != torch.float32 or n.numel() != 1:
        raise ValueError(f"n must be one float32 value, got {n.dtype} "
                         f"{tuple(n.shape)}")


def match_sigma(mean: torch.Tensor, mean_sq: torch.Tensor, n: torch.Tensor,
                width: int, floor: float) -> torch.Tensor:
    """``1 / (N n sigma)`` as a new float32 (Z, Y, ``width``) tensor from
    the moments ``mean`` and ``mean_sq`` (complex128, (Z, Y, ``width`` // 2
    + 1), one layout, inverted along z and y) and ``n`` (one float32 value
    on their device): 0 where ``w`` is at most ``floor`` of its largest
    (module docstring).  ``_build.launches()["match_sigma"]`` and
    ``["match_sigma_finish"]`` count the launches (the CPU path launches
    nothing); each CUDA call launches each once, for a ``width`` that
    :func:`supported` accepts."""
    width = int(width)
    _check(mean, mean_sq, n, width)
    if mean.device.type == "cpu":
        return plain_match_sigma(mean, mean_sq, n, width, floor)
    if not supported(width, mean.device):
        raise ValueError(f"the kernel takes a width of 1 to {MAX_WIDTH} on "
                         f"a CUDA device, got {width} on {mean.device}")
    depth, height = mean.shape[:2]
    out = torch.empty((depth, height, width), dtype=torch.float32,
                      device=mean.device)
    largest = torch.empty(1, dtype=torch.int32, device=mean.device)
    tables = (zpass.chirp_tables(points(width), torch.complex128,
                                 mean.device)
              if design(width) == "bluestein" else None)
    _LAUNCH(mean.device, mean.data_ptr(), mean_sq.data_ptr(), *mean.stride(),
            depth, height, width, n.data_ptr(), out.data_ptr(),
            largest.data_ptr(), None if tables is None else tables.data_ptr())
    _FINISH(mean.device, out.data_ptr(), out.numel(), largest.data_ptr(),
            floor)
    return out

"""Template matching's spectral pass along z: CUDA for CUDA tensors, plain
torch on the CPU.

:func:`match_zpass` takes the planes of a placed box's spectrum that are
transformed along y and x (the box's ``depth`` planes, zero elsewhere
along z) and, for each (y, x') column of the grid, its forward FFT along
z, the product with each spectrum and the inverse FFT along z, both
unnormalised: ``out_s = ifft_z(fft_z(columns) * spectrum_s)``.  No TPU
kernel stands behind it (the JAX package has no template matching); it
replaces three whole-grid passes of ``TemplateMatcher``'s correlation, the
forward's last pass, the product and the inverse's first, which stay here
as its plain version, :func:`plain_match_zpass`.  For CUDA tensors it
launches ``csrc/match_zpass.cu`` (built by ``nvcc`` at first use, see
:mod:`._build`) on the current stream without synchronising; for CPU
tensors it runs the plain version.  A CUDA tensor never falls back to the
plain version: the launch succeeds or the call raises.

The kernel takes any column length ``N`` up to ``MAX_POINTS``
(:func:`supported`), complex64 with one spectrum or complex128 with two:
a power of two from ``REGISTER_POINTS[0]`` to ``REGISTER_POINTS[1]``
through passes of radix 16 in registers, any other ``N`` through
Stockham passes in shared memory of its radices (16, 8, 4, 2, then its
odd primes: 3, 5 and 7 as compile-time butterflies, a prime up to
``MAX_DIRECT`` as paired direct sums).  An ``N`` with a larger prime
factor takes Bluestein's convolution instead: each DFT of ``N`` points is
a chirp times the circular convolution, by FFTs of the power of two ``L
>= 2N - 1`` (:func:`bluestein_length`), of the chirped column with the
chirp's conjugate, whose spectrum :func:`chirp_tables` computes once a
length, dtype and device, in float64.  Its FFTs are exact DFTs up to
rounding, as cuFFT's are, not cuFFT's bits.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NAME = "match_zpass"
SOURCE = "voltools_tpu_torch/csrc/match_zpass.cu"
MAX_POINTS = 2048
# the powers of two the register design takes
REGISTER_POINTS = (64, 1024)
# the largest prime factor the shared-memory design takes as direct sums;
# a length with a larger one takes Bluestein's convolution (on an H100,
# direct sums are the faster at 71 and Bluestein at 97: PERF.md)
MAX_DIRECT = 89
# the spectra a launch takes, by the dtype of its planes
SPECTRA = {torch.complex64: 1, torch.complex128: 2}

# match_zpass_launch's parameters
ARGTYPES = [
    ctypes.c_void_p,                                    # planes
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # their strides
    ctypes.c_void_p, ctypes.c_void_p,                   # spectra
    ctypes.c_void_p, ctypes.c_void_p,                   # outputs
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # their strides
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # N, depth, centre
    ctypes.c_int, ctypes.c_int,                         # Y, X'
    ctypes.c_void_p,                                    # Bluestein's tables
    ctypes.c_void_p,                                    # stream
]

LIBRARY = _build.Library(NAME, {"match_zpass_launch": ARGTYPES})
_LAUNCH = LIBRARY.launcher("match_zpass_launch", NAME)


def supported(points: int, device) -> bool:
    """Whether the kernel serves columns of ``points`` along z on
    ``device``: a CUDA device and 1 to ``MAX_POINTS`` points."""
    return torch.device(device).type == "cuda" and 1 <= points <= MAX_POINTS


def radices(points: int, top: int = 16) -> list:
    """The passes' radices of the shared-memory design for ``points``, as
    the source's ``radix_plan`` gives them: ``top`` (a power of two; 16
    for this kernel) while it divides, then the power of two left, then
    the odd primes, ascending."""
    out = []
    while points % top == 0:
        out.append(top)
        points //= top
    r = top // 2
    while r >= 2:
        if points % r == 0:
            out.append(r)
            points //= r
        r //= 2
    f = 3
    while points > 1:
        while points % f == 0:
            out.append(f)
            points //= f
        f += 2
    return out


def bluestein_length(points: int):
    """The length ``L`` of Bluestein's FFTs for ``points`` along z: the
    power of two at least ``2 points - 1`` where ``points`` has a prime
    factor above ``MAX_DIRECT``, else None (the Stockham passes take
    ``points`` as it is)."""
    n, largest, f = points, 1, 2
    while n > 1:
        while n % f == 0:
            n //= f
            largest = f
        f += 1
    if largest <= MAX_DIRECT:
        return None
    return 1 << (2 * points - 2).bit_length()


_TABLES: dict = {}


def chirp_tables(points: int, dtype, device) -> torch.Tensor:
    """Bluestein's tables for ``points`` along z, as the kernel reads them:
    the chirp ``w_z = exp(-i pi (z^2 mod 2 points) / points)``, ``z <
    points``, then the spectrum of the filter (``conj(w_z)`` at ``z`` and
    at ``L - z``, 0 between) divided by ``L``; computed once a length,
    dtype and device, in float64 on ``device``, then cast to ``dtype``."""
    key = (points, dtype, torch.device(device))
    if key not in _TABLES:
        length = bluestein_length(points)
        z = torch.arange(points, dtype=torch.int64, device=device)
        phase = (z * z % (2 * points)).to(torch.float64) * (-math.pi / points)
        w = torch.polar(torch.ones_like(phase), phase)
        b = torch.zeros(length, dtype=torch.complex128, device=device)
        b[:points] = w.conj()
        b[length - points + 1:] = w.conj()[1:].flip(0)
        _TABLES[key] = torch.cat([w, torch.fft.fft(b) / length]).to(dtype)
    return _TABLES[key]


def window(depth: int, centre: int, points: int, device=None) -> torch.Tensor:
    """Where the planes go along z: plane ``p`` at ``p`` for ``p <=
    centre``, at ``p + points - depth`` after it (a box point-reflected
    about ``centre`` and placed with it at the origin, wrapped)."""
    p = torch.arange(depth, device=device)
    return torch.where(p <= centre, p, p + points - depth)


def plain_match_zpass(planes: torch.Tensor, spectra, outs,
                      centre: int) -> None:
    """The kernel's plain version: the planes copied into ``window`` of
    zero columns, ``fft`` along z, the product with each spectrum, ``ifft``
    along z with ``norm="forward"``, each into its ``outs``."""
    points = spectra[0].shape[0]
    columns = planes.new_zeros((points,) + tuple(planes.shape[1:]))
    columns.index_copy_(0, window(planes.shape[0], centre, points,
                                  planes.device), planes)
    ft = torch.fft.fft(columns, dim=0)
    del columns
    for spectrum, out in zip(spectra, outs):
        out.copy_(torch.fft.ifft(ft * spectrum, dim=0, norm="forward"))


def _check(planes, spectra, outs, centre) -> None:
    tensors = {"planes": planes,
               **{f"spectra[{i}]": s for i, s in enumerate(spectra)},
               **{f"outs[{i}]": o for i, o in enumerate(outs)}}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        if t.dtype != planes.dtype:
            raise ValueError(f"{name} is {t.dtype}, the planes "
                             f"{planes.dtype}")
        if t.device != planes.device:
            raise ValueError(f"{name} is on {t.device}, the planes on "
                             f"{planes.device}")
        if t.ndim != 3 or min(t.stride()) < 0:
            raise ValueError(f"{name} must be 3-D with strides of 0 or "
                             "more")
    if planes.dtype not in SPECTRA:
        raise ValueError(f"the planes must be complex64 or complex128, got "
                         f"{planes.dtype}")
    if len(spectra) != SPECTRA[planes.dtype] or len(outs) != len(spectra):
        raise ValueError(f"{planes.dtype} takes {SPECTRA[planes.dtype]} "
                         f"spectra and as many outputs, got {len(spectra)} "
                         f"and {len(outs)}")
    shape = tuple(spectra[0].shape)
    for t in (*spectra, *outs):
        if tuple(t.shape) != shape or t.stride() != spectra[0].stride():
            raise ValueError("the spectra and the outputs must share one "
                             "shape and one layout")
    depth = planes.shape[0]
    if tuple(planes.shape[1:]) != shape[1:] or not 1 <= depth <= shape[0]:
        raise ValueError(f"planes {tuple(planes.shape)} do not fit columns "
                         f"of {shape}")
    if not 0 <= centre < depth:
        raise ValueError(f"centre {centre} is not a plane of {depth}")
    for out in outs:
        if any(out.data_ptr() == t.data_ptr() for t in (planes, *spectra)):
            raise ValueError("an output may not share memory with an input")


def match_zpass(planes: torch.Tensor, spectra, outs, centre: int) -> None:
    """``outs[s] = ifft_z(fft_z(columns) * spectra[s])``, unnormalised, where
    the columns hold ``planes`` ((depth, Y, X')) at the z positions of
    :func:`window` and zeros elsewhere; ``spectra`` and ``outs`` (N, Y,
    X'), one layout, one spectrum for complex64 and two for complex128.
    ``_build.launches()["match_zpass"]`` counts the kernel launches (the
    CPU path launches nothing); each CUDA call launches once, and takes an
    ``N`` that :func:`supported` accepts."""
    spectra, outs, centre = tuple(spectra), tuple(outs), int(centre)
    _check(planes, spectra, outs, centre)
    if planes.device.type == "cpu":
        plain_match_zpass(planes, spectra, outs, centre)
        return
    points = spectra[0].shape[0]
    if not supported(points, planes.device):
        raise ValueError(f"the kernel takes 1 to {MAX_POINTS} points along "
                         f"z on a CUDA device, got {points} on "
                         f"{planes.device}")
    wide = len(spectra) == 2
    tables = (chirp_tables(points, planes.dtype, planes.device)
              if bluestein_length(points) else None)
    _LAUNCH(planes.device,
            planes.data_ptr(), *planes.stride(),
            spectra[0].data_ptr(), spectra[1].data_ptr() if wide else None,
            outs[0].data_ptr(), outs[1].data_ptr() if wide else None,
            *spectra[0].stride(), points, planes.shape[0],
            centre, spectra[0].shape[1], spectra[0].shape[2],
            None if tables is None else tables.data_ptr())

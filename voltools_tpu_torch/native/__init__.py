"""Native (C++) CPU backend: the port's counterpart of
``voltools_tpu/native/__init__.py``.

``affine_cpu.cpp`` (the port's own copy of the JAX package's source) is
built by ``g++`` with the JAX package's flags into
``voltools_tpu_torch/_build/``, named by a hash of the source and the flags,
at first use -- never at import -- and bound with ctypes.  It is the
multithreaded host resampler and B-spline prefilter behind
``affine(..., device='cpu', cpu_backend='native')``.  Where no compiler is
available, :func:`available` reports False; the entry points then raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "affine_cpu.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-lpthread",)

_LOCK = threading.Lock()
_LIB = None
_BUILD_ERROR = None


def library_path() -> Path:
    """Where the library lives: named by a hash of the source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_DIR / f"libaffine_cpu_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``affine_cpu.cpp`` unless its library is already built."""
    target = library_path()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent builders (test
    # workers, threads) never load a half-written library
    partial = target.with_name(
        f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(partial), str(SOURCE), *GXX_LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as exc:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed ({exc.returncode}) building {SOURCE.name}:\n"
            f"{' '.join(cmd)}\n{exc.stdout}\n{exc.stderr}") from exc
    os.replace(partial, target)
    return target


def _load():
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is not None or _BUILD_ERROR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as exc:  # no compiler, or no build
            _BUILD_ERROR = exc
            return None
        lib.vt_affine_transform.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ]
        lib.vt_affine_transform.restype = None
        lib.vt_bspline_prefilter.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        lib.vt_bspline_prefilter.restype = None
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the native library builds and loads on this host."""
    return _load() is not None


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native backend unavailable: {_BUILD_ERROR}")
    return lib


def _n_threads() -> int:
    return max(1, os.cpu_count() or 1)


def bspline_prefilter(volume: np.ndarray) -> np.ndarray:
    """Mirror-boundary cubic B-spline prefilter (in a copy)."""
    lib = _library()
    out = np.ascontiguousarray(volume, dtype=np.float32).copy()
    lib.vt_bspline_prefilter(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        *map(ctypes.c_int64, out.shape), _n_threads())
    return out


def affine_transform(volume: np.ndarray, matrix: np.ndarray,
                     interpolation: str = "linear", mode: str = "constant",
                     cval: float = 0.0, out_shape=None,
                     output: np.ndarray = None) -> np.ndarray:
    """Native equivalent of scipy.ndimage.affine_transform for the
    library's modes; fills and returns ``output`` when given one."""
    from ..ops.interpolation import needs_prefilter, spline_order

    lib = _library()
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    if needs_prefilter(interpolation):
        vol = bspline_prefilter(vol)
    order = spline_order(interpolation)

    if out_shape is None:
        out_shape = vol.shape
    if output is None:
        output = np.empty(tuple(out_shape), dtype=np.float32)
    else:
        # the C code writes float32 through a raw pointer; anything else
        # would be silently reinterpreted
        if output.dtype != np.float32:
            raise ValueError(
                f"output must be float32 for the native backend, got "
                f"{output.dtype}")
        if not output.flags["C_CONTIGUOUS"]:
            raise ValueError("output must be C-contiguous for the native "
                             "backend")
        if tuple(output.shape) != tuple(out_shape):
            raise ValueError(
                f"output shape {output.shape} != expected {tuple(out_shape)}")

    m = np.ascontiguousarray(np.asarray(matrix, dtype=np.float64)[:3, :4])
    lib.vt_affine_transform(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        *map(ctypes.c_int64, vol.shape),
        output.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        *map(ctypes.c_int64, output.shape),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        order, 1 if mode == "border" else 0, ctypes.c_float(cval),
        _n_threads())
    return output

"""The slab affine kernel: CUDA for CUDA tensors, plain torch on the CPU.

:func:`affine_slab` is the port of the TPU select-tree Pallas kernel
(``voltools_tpu/kernels/pallas_affine.py::_make_kernel``).  It computes the
same function as :func:`.affine_resample.affine_resample`, bit for bit on
the card, but its persistent CTAs stage the source box of each output brick
in shared memory with TMA, ``planner.STAGES`` boxes in flight per CTA
(``csrc/affine_slab.cu``).  The box extents come from a
:class:`~.planner.SlabPlan`; :func:`.planner.slab_plan` says when the kernel
can take a launch, :func:`.planner.choose_plan` when it is the faster one.
TMA reads the volume as it lies, so a CUDA volume must be pitched
(:func:`.layout.pitched`); any other raises.

For a CUDA volume it launches the kernel (built by ``nvcc`` at first use,
see :mod:`._build`) on the current stream without synchronising; for a CPU
volume it runs the kernels' plain version (:mod:`voltools_tpu_torch.ops.
sampling`), the same as :mod:`.affine_resample`'s, because the function is
the same.  A CUDA tensor never falls back to the plain version: the launch
succeeds or the call raises.

The kernel never reads a tap from outside its box.  A matrix whose box
exceeds the plan's extents is still resampled right, from global memory,
and counted on the device: :func:`overflows` reads the count.  A launch
takes any number of matrices: its grid is persistent and walks them all.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .affine_resample import (_MODES, _PLAIN_INTERPOLATION, _check,
                              _check_launch, _device_index, _plain)
from .layout import ROW_ALIGN, row_pitch, tma_ready
from .planner import MAX_BOX, STAGES, SlabPlan, slab_extents, slab_plan

NAME = "affine_slab"
SOURCE = "voltools_tpu_torch/csrc/affine_slab.cu"
REPLACES = "voltools_tpu/kernels/pallas_affine.py:223"

# per CUDA device index: the kernel's int32 overflow counter
_OVERFLOWS: dict = {}


@functools.lru_cache(maxsize=1)
def _library():
    lib = _build.load(NAME)
    fn = lib.affine_slab_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # volume
        ctypes.c_int,                                               # pitch
        ctypes.c_void_p, ctypes.c_longlong,                         # matrices
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # output
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                   # box
        ctypes.c_int,                                               # stages
        ctypes.c_int, ctypes.c_int, ctypes.c_float,       # order, border, cval
        ctypes.c_void_p,                                  # overflow counter
        ctypes.c_void_p,                                  # stream
    ]
    fn.restype = ctypes.c_int
    occ = lib.affine_slab_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,   # box
                    ctypes.c_int,                               # stages
                    ctypes.c_int, ctypes.c_int,                 # order, border
                    ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    lib.affine_slab_error_string.argtypes = [ctypes.c_int]
    lib.affine_slab_error_string.restype = ctypes.c_char_p
    return lib


def overflows(device="cuda") -> int:
    """How many voxels the kernel found with a tap outside their box on
    ``device``, in this process.  Reading it waits for the device."""
    counter = _OVERFLOWS.get(_device_index(device))
    return 0 if counter is None else int(counter.item())


def blocks_per_sm(plan: SlabPlan, device="cuda") -> int:
    """How many CTAs of a launch with ``plan``'s box share one SM of the
    CUDA ``device`` at a time (the occupancy the kernel runs at; its
    persistent grid is this many CTAs per SM)."""
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(torch.device("cuda", _device_index(device))):
        code = lib.affine_slab_blocks_per_sm(
            *plan.extents, STAGES, plan.order, _MODES[plan.mode],
            ctypes.byref(blocks))
    if code != 0:
        message = lib.affine_slab_error_string(code).decode()
        raise RuntimeError(f"affine_slab occupancy query failed: {message}")
    return blocks.value


def _counter(device: torch.device) -> torch.Tensor:
    index = _device_index(device)
    counter = _OVERFLOWS.get(index)
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32,
                              device=torch.device("cuda", index))
        _OVERFLOWS[index] = counter
    return counter


def _fit_plan(plan, volume, matrices, order, mode, out_shape) -> SlabPlan:
    """The plan of this launch, checked against its arguments."""
    interpolation = _PLAIN_INTERPOLATION[order]
    vol_shape = tuple(volume.shape)
    if plan is None:
        # a CUDA tensor is read back to the host here: callers that hold
        # the matrices on the host plan there and pass the plan
        host = matrices.detach().cpu().numpy()
        plan = slab_plan(host, vol_shape, interpolation, mode, out_shape)
        if plan is None:
            extents = slab_extents(host, vol_shape, order, out_shape)
            raise ValueError(
                f"the slab kernel cannot take these matrices: their box "
                f"{extents} ({4 * int(np.prod(extents))} bytes) is over its "
                f"shared-memory budget or TMA's box; affine_resample "
                f"serves them")
        return plan
    if not isinstance(plan, SlabPlan):
        raise TypeError(f"plan must be a SlabPlan, got {type(plan).__name__}")
    if plan.extents[2] % ROW_ALIGN or max(plan.extents) > MAX_BOX:
        raise ValueError(
            f"TMA takes boxes of at most {MAX_BOX} voxels along an axis and "
            f"x a multiple of {ROW_ALIGN}, not {plan.extents}")
    if (plan.order, plan.mode, plan.vol_shape, plan.out_shape) != (
            order, mode, vol_shape, out_shape):
        raise ValueError(
            f"plan for order {plan.order}, {plan.mode!r}, volume "
            f"{plan.vol_shape} -> {plan.out_shape} does not match the call: "
            f"order {order}, {mode!r}, volume {vol_shape} -> {out_shape}")
    if matrices.device.type == "cpu":
        need = slab_extents(matrices.numpy(), vol_shape, order, out_shape)
        if any(a > b for a, b in zip(need, plan.extents)):
            raise ValueError(
                f"these matrices need a box of {need}, over the plan's "
                f"{plan.extents}")
    return plan


def affine_slab(volume: torch.Tensor, matrices: torch.Tensor, order: int,
                mode: str = "constant", cval: float = 0.0, out_shape=None,
                out: torch.Tensor = None,
                plan: SlabPlan = None) -> torch.Tensor:
    """Resample ``volume`` (D, H, W) through pull-back ``matrices`` with the
    slab kernel.

    Arguments and result as :func:`.affine_resample.affine_resample`, but
    any number of matrices goes in one launch, and a CUDA volume must be
    pitched (:func:`.layout.tma_ready`; :func:`.layout.pitched` makes it
    so).  ``plan`` is the :class:`~.planner.SlabPlan` of these matrices from
    :func:`.planner.slab_plan` or :func:`.planner.choose_plan`; the launch
    stages boxes of its extents, ``planner.STAGES`` of them per CTA.
    Without a plan, one is made here (for a CUDA tensor that reads the
    matrices back to the host), and a call whose box the kernel cannot take
    raises.
    Matrices on the CPU that need more than a given plan's extents raise;
    on the card the kernel counts them (:func:`overflows`).
    ``affine_slab.launches`` counts the kernel launches (the CPU path
    launches nothing)."""
    out_shape = (tuple(volume.shape) if out_shape is None
                 else tuple(int(s) for s in out_shape))
    full = _check(volume, matrices, order, mode, out_shape, out)
    plan = _fit_plan(plan, volume, matrices, order, mode, out_shape)

    if volume.device.type == "cpu":
        return _plain(volume, matrices, order, mode, cval, out_shape, out)
    n = _check_launch(volume, matrices, max_batch=None)
    if not tma_ready(volume):
        raise ValueError(
            f"TMA reads rows of a multiple of 16 bytes from 16-byte aligned "
            f"memory; this volume's rows are {row_pitch(volume)} floats "
            f"apart: pass layout.pitched(volume)")
    if out is None:
        out = torch.empty(full, dtype=torch.float32, device=volume.device)
    if n == 0:
        return out
    lib = _library()
    # the launch goes to the current device; make it the volume's for the
    # call only, so the caller's current device is left as it was
    with torch.cuda.device(volume.device):
        code = lib.affine_slab_launch(
            volume.data_ptr(), *volume.shape, row_pitch(volume),
            matrices.data_ptr(), n, out.data_ptr(), *out_shape,
            *plan.extents, STAGES, order, _MODES[mode], float(cval),
            _counter(volume.device).data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        message = lib.affine_slab_error_string(code).decode()
        raise RuntimeError(f"affine_slab launch failed: {message} ({code})")
    affine_slab.launches += 1
    return out


affine_slab.launches = 0

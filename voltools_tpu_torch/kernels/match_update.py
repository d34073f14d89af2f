"""Template matching's update kernel: CUDA for CUDA tensors, plain torch on
the CPU.

:func:`match_update` scores one orientation and keeps the running best:
``s = cc * inv``; where ``s > scores``, ``indices`` becomes the
orientation's ``index``; ``scores`` becomes ``torch.maximum(scores, s)``.
No TPU kernel stands behind it (the JAX package has no template matching);
it replaces the four torch kernels that ``TemplateMatcher`` ran for the
update, which stay here as its plain version, :func:`plain_match_update`.
For CUDA tensors it launches ``csrc/match_update.cu`` (built by ``nvcc`` at
first use, see :mod:`._build`) on the current stream without
synchronising; for CPU tensors it runs the plain version.  A CUDA tensor
never falls back to the plain version: the launch succeeds or the call
raises.

The kernel reads ``cc``, ``inv`` and ``scores`` once and writes a score
and an index only where the orientation changes them; it equals the plain
version bit for bit, NaN, infinities and the sign of a zero included (the
source's note says how).  It counts on the device the voxels whose best it
replaced (``s > scores``): :func:`improved_voxels` reads the count.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "match_update"
SOURCE = "voltools_tpu_torch/csrc/match_update.cu"

# match_update_launch's parameters
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p,          # cc, inv
    ctypes.c_void_p, ctypes.c_void_p,          # scores, indices
    ctypes.c_longlong, ctypes.c_int,           # voxels, the index
    ctypes.c_void_p,                           # improved-voxel counter
    ctypes.c_void_p,                           # stream
]

LIBRARY = _build.Library(NAME, {"match_update_launch": ARGTYPES},
                         counters={"improved_voxels": (torch.int64, 1)})
_LAUNCH = LIBRARY.launcher("match_update_launch", NAME)


def plain_match_update(cc: torch.Tensor, inv: torch.Tensor,
                       scores: torch.Tensor, indices: torch.Tensor,
                       index: int) -> None:
    """The kernel's plain version, the four torch kernels it replaces:
    the scaled correlation, the strict compare, the maximum, the masked
    fill.  Updates ``scores`` and ``indices`` in place; ``cc`` is left as
    it is."""
    s = cc * inv
    better = torch.gt(s, scores)
    torch.maximum(scores, s, out=scores)
    indices.masked_fill_(better, index)


def improved_voxels(device="cuda") -> int:
    """How many voxels the kernel's launches on ``device`` gave a new best
    (``s > scores``) in this process.  Reading it waits for the device."""
    return LIBRARY.read("improved_voxels", device)


def _check(cc, inv, scores, indices, index) -> None:
    maps = {"cc": cc, "inv": inv, "scores": scores, "indices": indices}
    for name, t in maps.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        want = torch.int32 if name == "indices" else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
        if t.shape != cc.shape:
            raise ValueError(f"{name}'s shape {tuple(t.shape)} is not cc's "
                             f"{tuple(cc.shape)}")
        if t.device != cc.device:
            raise ValueError(f"{name} is on {t.device}, cc on {cc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if cc.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if cc.numel() < 1:
        raise ValueError("the maps are empty")
    if not -2 ** 31 <= index < 2 ** 31:
        raise ValueError(f"index {index} does not fit in int32")


def match_update(cc: torch.Tensor, inv: torch.Tensor, scores: torch.Tensor,
                 indices: torch.Tensor, index: int) -> None:
    """Update the best ``scores`` (float32) and their ``indices`` (int32)
    in place with orientation ``index``, whose correlation is ``cc``,
    scaled by ``inv`` (both float32); all four contiguous, of one shape,
    on one device.  ``_build.launches()["match_update"]`` counts the
    kernel launches (the CPU path launches nothing); each CUDA call
    launches once."""
    index = int(index)
    _check(cc, inv, scores, indices, index)
    if cc.device.type == "cpu":
        plain_match_update(cc, inv, scores, indices, index)
        return
    if cc.device.type != "cuda":
        raise ValueError(f"unsupported device {cc.device}")
    _LAUNCH(cc.device,
            cc.data_ptr(), inv.data_ptr(), scores.data_ptr(),
            indices.data_ptr(), cc.numel(), index,
            LIBRARY.counter("improved_voxels", cc.device).data_ptr())

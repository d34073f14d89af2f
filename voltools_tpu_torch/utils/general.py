"""Device registry, reshape geometry, and profiling helpers.

The PyTorch port's counterpart of ``voltools_tpu/utils/general.py``:

* ``get_available_devices`` enumerates ``'cpu'`` plus ``'cuda'`` /
  ``'cuda:N'`` for every visible CUDA device (the reference's ``'gpu'`` /
  ``'gpu:N'`` registry, reference ``general.py:61-80``).
* ``resolve_device`` maps a device string to a ``torch.device`` and rejects
  malformed or absent ordinals.
* ``compute_post_transform_dimensions`` re-derives the ``reshape=True``
  bounding-box geometry (reference ``general.py:92-123``).
* ``full_fp32_matmul`` runs a block's float32 matrix products in full
  float32 (no TF32), the analogue of the JAX package's
  ``precision=HIGHEST``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Tuple

import numpy as np
import torch


def get_available_devices():
    """Usable device strings: always ``['cpu']``, plus ``'cuda'`` and
    ``'cuda:0'`` .. ``'cuda:N-1'`` when CUDA devices are visible."""
    devices = ["cpu"]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count:
        devices.append("cuda")
        devices.extend(f"cuda:{i}" for i in range(count))
    return devices


def resolve_device(device: str) -> torch.device:
    """Map ``'cpu'``, ``'cuda'`` or ``'cuda:N'`` to a ``torch.device``.

    ``'cuda:'`` and ``'cuda:x'`` are malformed (not ``cuda:0``), and an
    ordinal past the visible devices is an error, never a silent rebind."""
    if device == "cpu":
        return torch.device("cpu")
    if device == "cuda" or device.startswith("cuda:"):
        if device == "cuda":
            idx = 0
        else:
            ordinal = device[5:]
            if not ordinal.isdigit():
                raise ValueError(f"Unknown device string: {device!r}")
            idx = int(ordinal)
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise ValueError(
                f"No CUDA device available for {device!r}; use device='cpu'")
        if idx >= count:
            raise ValueError(
                f"Unknown device ({device!r}): only {count} CUDA device(s) "
                f"present (cuda:0..cuda:{count - 1})")
        return torch.device("cuda", idx)
    raise ValueError(f"Unknown device string: {device!r}")


def compute_post_transform_dimensions(
        shape: Tuple[int, int, int],
        transform_m: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padding and output shape needed so the transformed volume fits fully.

    Pushes the 8 corners of the volume's bounding box through the *forward*
    map (inverse of the pull-back matrix) and derives per-axis padding.
    Returns ``(pad_before, pad_after, new_dims)`` as int arrays of length 3.
    """
    d0, d1, d2 = shape
    corners = np.array(
        [[z, y, x, 1.0] for z in (0, d0) for y in (0, d1) for x in (0, d2)],
        dtype=np.float64).T  # (4, 8)

    try:
        forward = np.linalg.inv(np.asarray(transform_m, dtype=np.float64))
    except np.linalg.LinAlgError:
        raise np.linalg.LinAlgError(
            "transform matrix is singular; cannot derive reshape geometry")

    moved = np.round(forward @ corners).astype(int)  # (4, 8)
    dims = np.array([d0, d1, d2, 1])

    pad_before = -np.minimum(moved, 0).min(axis=1)
    overhang = np.maximum(moved - dims[:, None], 0).max(axis=1)
    new_dims = pad_before + dims + overhang
    return pad_before[:3], overhang[:3], new_dims[:3]


@contextlib.contextmanager
def full_fp32_matmul():
    """Run float32 matrix products in full float32 (no TF32), restoring the
    caller's settings afterwards."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    prev_precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        torch.set_float32_matmul_precision(prev_precision)


class ProfileTimer:
    """Wall-clock bracket that prints in the reference's format
    ('transform finished in X.XXXms', reference ``transforms.py:157,219``).

    CUDA work is asynchronous, so the bracket synchronizes ``device`` (the
    call's device; ``None``: the current CUDA device) on entry and exit:
    the printed time covers execution there, not the enqueue.  A CPU
    device needs no synchronisation."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)

    def _synchronize(self):
        if self.device is not None and self.device.type != "cuda":
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._synchronize()
        elapsed_ms = (time.perf_counter() - self._t0) * 1000.0
        print(f"transform finished in {elapsed_ms:.3f}ms")
        return False

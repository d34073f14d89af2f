"""The general generator that every traffic mix's data file feeds.

Rewritten from the originals in NumPy and PyTorch:

* :func:`rotation_pool`: the reference benchmark's draw, rotations uniform
  in [-180, 180)^3, 'sxyz', about center = size / 2 (voltools
  ``tests/benchmark.py:52-54``, ``bench.py:450-459``), vectorised: the
  Euler matrix of ``voltools_tpu_torch/utils/matrices.py::rotation_matrix``
  (Gohlke's convention, angles negated) for the static 'xyz' frame.
* :func:`tilt_series`: ``chip_smoke.py:433`` (``tilt_series``): a
  single-axis series, here the rotation about array axis 2 that 'rzxz'
  gives with the angle at position 0, about center = (n - 1) / 2.
* :func:`blob_phantom`: ``chip_smoke.py:486`` (``blob_phantom``, after
  ``examples/registration.py:30-39``) made on the device from the seed:
  a sum of separable Gaussian blobs, no host work and no scipy.

Matrices are built in float64 and rounded once to float32.
"""

from __future__ import annotations

import numpy as np
import torch


def seeded(seed: int):
    """(host ``numpy.random.Generator``, device ``torch.Generator`` maker)
    of ``seed``; any whole number, reduced into 63 bits for torch."""
    rng = np.random.default_rng(int(seed))

    def device_generator(device):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (2 ** 63))
        return gen

    return rng, device_generator


def sxyz_matrices(angles_deg: np.ndarray, center) -> np.ndarray:
    """(N, 4, 4) float32 pull-back matrices of 'sxyz' Euler angles (N, 3)
    in degrees about ``center``: ``src = R (out - c) + c``."""
    a = -np.deg2rad(np.asarray(angles_deg, np.float64))   # CCW convention
    si, sj, sk = np.sin(a[:, 0]), np.sin(a[:, 1]), np.sin(a[:, 2])
    ci, cj, ck = np.cos(a[:, 0]), np.cos(a[:, 1]), np.cos(a[:, 2])
    cc, cs, sc, ss = ci * ck, ci * sk, si * ck, si * sk
    r = np.empty((len(a), 3, 3))
    r[:, 0, 0], r[:, 0, 1], r[:, 0, 2] = cj * ck, sj * sc - cs, sj * cc + ss
    r[:, 1, 0], r[:, 1, 1], r[:, 1, 2] = cj * sk, sj * ss + cc, sj * cs - sc
    r[:, 2, 0], r[:, 2, 1], r[:, 2, 2] = -sj, cj * si, cj * ci
    return _about(r, center)


def _about(r: np.ndarray, center) -> np.ndarray:
    c = np.asarray(center, np.float64)
    m = np.zeros((len(r), 4, 4))
    m[:, :3, :3] = r
    m[:, :3, 3] = c - r @ c
    m[:, 3, 3] = 1.0
    return m.astype(np.float32)


def rotation_pool(rng: np.random.Generator, n: int, size) -> np.ndarray:
    """``n`` random rotations of a ``size`` volume, the reference
    benchmark's draw: (n, 4, 4) float32."""
    angles = rng.uniform(-180.0, 180.0, (n, 3))
    return sxyz_matrices(angles, np.asarray(size, np.float64) / 2)


def tilt_series(angles_deg, shape) -> np.ndarray:
    """The single-axis tilt series about array axis 2 through the center
    (n - 1) / 2 of ``shape``: what
    ``TiltSeriesProjector(..., rotation_order='rzxz').tilt_matrices(
    angles, tilt_axis=0)`` builds.  (N, 4, 4) float32."""
    a = -np.deg2rad(np.asarray(angles_deg, np.float64))
    c, s = np.cos(a), np.sin(a)
    r = np.zeros((len(a), 3, 3))
    r[:, 0, 0], r[:, 0, 1] = c, -s
    r[:, 1, 0], r[:, 1, 1] = s, c
    r[:, 2, 2] = 1.0
    return _about(r, (np.asarray(shape, np.float64) - 1) / 2)


def blob_phantom(shape, blobs: int, sigma, region, gen: torch.Generator,
                 device) -> torch.Tensor:
    """A float32 volume of ``shape``: ``blobs`` Gaussian blobs of unit
    height, each sigma uniform in ``sigma`` = [lo, hi] voxels, centers
    uniform in the box ``region`` = [lo, hi] fractions of each extent."""
    shape = tuple(int(s) for s in shape)
    ext = torch.tensor(shape, dtype=torch.float32, device=device)
    lo, hi = region
    centers = (lo + (hi - lo) * torch.rand((blobs, 3), generator=gen,
                                           device=device)) * ext
    sigmas = sigma[0] + (sigma[1] - sigma[0]) * torch.rand(
        (blobs,), generator=gen, device=device)
    axes = [torch.arange(n, dtype=torch.float32, device=device)
            for n in shape]
    # per blob and axis a 1-D Gaussian; the blob is their outer product
    prof = [torch.exp(-0.5 * ((axes[a][None, :] - centers[:, a:a + 1])
                              / sigmas[:, None]) ** 2) for a in range(3)]
    vol = torch.zeros(shape, dtype=torch.float32, device=device)
    for b in range(blobs):
        vol.addcmul_(prof[0][b].view(-1, 1, 1),
                     prof[1][b].view(1, -1, 1) * prof[2][b].view(1, 1, -1))
    return vol


def sample_indices(rng: np.random.Generator, count: int, upto: int):
    """``min(count, upto)`` distinct call indices drawn from [0, upto),
    sorted."""
    upto = max(int(upto), 1)
    picked = rng.choice(upto, size=min(int(count), upto), replace=False)
    return sorted(int(i) for i in picked)

"""Template matching: the best local correlation of a rotated template
with a tomogram, voxel by voxel, over a sequence of orientations.

The port's counterpart of pytom-match-pick's GPU matcher
(``pytom_tm/matching.py``; Chaillet et al., Int. J. Mol. Sci. 24:13375,
2023), whose score is Roseman's fast local correlation function
(Ultramicroscopy 94:225, 2003).  The JAX package has no template
matching.

:class:`TemplateMatcher` keeps the tomogram's spectrum, its local
statistics under the mask and the two result maps on the device.  For
each orientation, a 4x4 pull-back matrix about the template's centre
``c = n // 2`` on each axis (as :meth:`StaticVolume.affine` takes it):

1. ``match.template``: the template is rotated by a ``StaticVolume``
   (``filt_bspline`` by default) into a preallocated box; its missing
   wedge is applied, ``irfftn(rfftn(box) * W)``; it is normalised to mean
   0 and standard deviation 1 under the mask ``M`` (weights ``M``,
   ``n = sum(M)``) and multiplied by ``M``; and it is placed in a
   tomogram-sized zero volume with its centre at the origin;
2. ``match.correlate``: ``rfftn`` of that volume, the product with the
   tomogram's spectrum, ``irfftn``;
3. ``match.update``: the correlation divided by ``n * sigma_local`` is the
   score; where it is greater than the best so far, the best and the
   orientation's index are replaced, in one pass of the update kernel
   (:mod:`..kernels.match_update`) on the card, which writes only the
   voxels the orientation changes.

So the score at voxel ``x`` is ``sum_y T(y) V(x + y - c) / (n
sigma(x))``, ``T`` the normalised template, with ``sigma(x)`` the
tomogram's standard deviation under ``M`` placed the same way; the
indices wrap around the tomogram's edges, as every FFT correlation does.

Departures from pytom-match-pick, none of which changes the score in
exact arithmetic:

* The template is placed point-reflected, at ``(c - y) mod N``: the
  spectrum of a reflected real volume is the conjugate of its spectrum,
  so the correlation's product is one multiply in place.  pytom pastes it
  at the tomogram's centre and shifts the maps back at the end; here its
  centre lands at the origin and no shift is needed.
* The inverse transform is left unnormalised; its ``1 / N`` is folded
  into the stored ``1 / (N n sigma)`` map.
* The tomogram is brought to mean 0 and standard deviation 1, and its
  spectrum and local statistics are computed once, in float64, then kept
  as complex64 and float32 (pytom computes in float32).  The score does
  not depend on the tomogram's offset or scale.
* Where ``sigma`` is at most ``1e-6`` of its largest value, the score is 0
  (pytom divides by it as it is).
* The wedge is binary, from the tilt range alone: no tilt-angle
  weighting, CTF, dose or whitening filter, and none on the tomogram.
* Only masks that are functions of the distance from the centre are
  taken (pytom recomputes ``sigma`` for each orientation under a rotated
  mask otherwise); :class:`TemplateMatcher` raises on any other.
* Orientations are the caller's matrices, and an index is the position
  of its orientation among those scored since :meth:`reset` (pytom keeps
  the index into its angle list).  The best starts at ``-inf`` and the
  index at ``-1``; a template flat under the mask scores 0.
* The whole tomogram is scored at once, without pytom's split into
  sub-volumes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.match_update import match_update
from ..transforms import _as_tensor, _device
from ..utils import trace
from ..volume import StaticVolume

__all__ = ["TemplateMatcher", "missing_wedge"]

# a sigma at most this share of the largest scores 0
SIGMA_FLOOR = 1e-6
# degrees by which a frequency on a bound of the tilt range is kept
WEDGE_TOLERANCE = 1e-9
# a mask is spherical when the values at one distance from the centre
# differ by at most this share of its largest value
SPHERICAL_TOLERANCE = 1e-6


def missing_wedge(box, tilt_range=(-60.0, 60.0), tilt_axis: int = 2,
                  projection_axis: int = 0, device=None) -> torch.Tensor:
    """The binary wedge of a single-axis tilt series on the ``rfftn`` grid
    of a volume of shape ``box``, float32: 1 at the frequencies the series
    measured, 0 in the missing wedge.

    The beam runs along ``projection_axis`` at tilt 0 and the series tilts
    about ``tilt_axis``; ``q`` is the third axis.  A frequency ``k`` (cycles
    a voxel) is kept where its angle from the ``q`` axis toward the
    projection axis, ``atan(k_p / k_q)``, lies in ``tilt_range`` (degrees,
    within ``WEDGE_TOLERANCE``, so that a frequency on a bound is kept
    whatever the rounding): for (-60, 60), ``|k_p| <= tan(60) |k_q|``.  The
    zero frequency is kept."""
    box = tuple(int(s) for s in box)
    if len(box) != 3:
        raise ValueError(f"expected a 3-D box, got {box}")
    if tilt_axis == projection_axis or not {
            tilt_axis, projection_axis} <= {0, 1, 2}:
        raise ValueError("tilt_axis and projection_axis must be two "
                         f"different axes of 0, 1, 2; got {tilt_axis}, "
                         f"{projection_axis}")
    lo, hi = (float(a) for a in tilt_range)
    if not -90.0 < lo <= hi < 90.0:
        raise ValueError(f"tilt_range must lie inside (-90, 90), got "
                         f"{tilt_range}")
    q = 3 - tilt_axis - projection_axis
    grids = []
    for axis, n in enumerate(box):
        f = (torch.fft.rfftfreq(n, dtype=torch.float64) if axis == 2 else
             torch.fft.fftfreq(n, dtype=torch.float64))
        shape = [1, 1, 1]
        shape[axis] = -1
        grids.append(f.view(shape))
    kp, kq = grids[projection_axis], grids[q]
    # (k_p, k_q) and (-k_p, -k_q) lie on one line: fold onto k_q >= 0
    angle = torch.rad2deg(torch.atan2(torch.where(kq < 0, -kp, kp),
                                      kq.abs()))
    keep = (angle >= lo - WEDGE_TOLERANCE) & (angle <= hi + WEDGE_TOLERANCE)
    rshape = box[:2] + (box[2] // 2 + 1,)
    return keep.expand(rshape).to(torch.float32).to(device).contiguous()


def _check_spherical(mask: torch.Tensor, centre) -> None:
    """Raise unless ``mask`` is a function of the distance from ``centre``:
    every value at one squared distance the same, within
    ``SPHERICAL_TOLERANCE`` of the largest."""
    grids = [(torch.arange(n, device=mask.device) - c) ** 2
             for n, c in zip(mask.shape, centre)]
    r2 = (grids[0].view(-1, 1, 1) + grids[1].view(1, -1, 1)
          + grids[2].view(1, 1, -1)).reshape(-1)
    values = mask.reshape(-1).to(torch.float64)
    bins = int(r2.max()) + 1
    lo = torch.full((bins,), math.inf, dtype=torch.float64,
                    device=mask.device).scatter_reduce(0, r2, values, "amin")
    hi = torch.full((bins,), -math.inf, dtype=torch.float64,
                    device=mask.device).scatter_reduce(0, r2, values, "amax")
    seen = torch.isfinite(lo)
    spread = float((hi[seen] - lo[seen]).max())
    if spread > SPHERICAL_TOLERANCE * float(values.abs().max()):
        raise ValueError(
            "the mask is not spherical about the template's centre (n // 2 "
            f"on each axis): values at one distance differ by {spread:.3g}; "
            "rotated masks are not supported")


def _placed(volume: torch.Tensor, shape, centre, reflect: bool):
    """``volume`` in a zero volume of ``shape``, its voxel ``centre`` at the
    origin, indices wrapped; point-reflected about it with ``reflect``.
    Returns the flat destination index of each voxel, in ``volume``'s
    order."""
    idx = []
    for n, c, size in zip(volume.shape, centre, shape):
        y = torch.arange(n, device=volume.device)
        idx.append(((c - y) if reflect else (y - c)) % size)
    return ((idx[0].view(-1, 1, 1) * shape[1] + idx[1].view(1, -1, 1))
            * shape[2] + idx[2].view(1, 1, -1)).reshape(-1)


def _tomogram_terms(tomogram: torch.Tensor, mask: torch.Tensor, centre,
                    n_mask: float):
    """The normalised tomogram's spectrum (complex64) and ``1 / (N n
    sigma)`` (float32, 0 where sigma is under its floor), computed in
    float64."""
    shape = tuple(tomogram.shape)
    v = tomogram.to(torch.float64)
    v = v - v.mean()
    scale = v.square().mean().sqrt()
    if float(scale) > 0:
        v = v / scale
    spectrum = torch.fft.rfftn(v)
    padded = torch.zeros(shape, dtype=torch.float64, device=v.device)
    padded.view(-1)[_placed(mask, shape, centre, reflect=False)] = \
        mask.reshape(-1).to(torch.float64)
    mask_ft = torch.fft.rfftn(padded).conj_physical_()
    del padded
    mean = torch.fft.irfftn(mask_ft * spectrum, s=shape) / n_mask
    mean_sq = torch.fft.irfftn(mask_ft * torch.fft.rfftn(v.square()),
                               s=shape) / n_mask
    del mask_ft, v
    sigma = (mean_sq - mean.square()).clamp_min_(0.0).sqrt_()
    del mean, mean_sq
    floor = SIGMA_FLOOR * float(sigma.max())
    n_voxels = float(np.prod(shape))
    inv = torch.where(sigma > floor, 1.0 / (n_voxels * n_mask * sigma),
                      torch.zeros((), dtype=torch.float64,
                                  device=sigma.device))
    return spectrum.to(torch.complex64), inv.to(torch.float32)


class TemplateMatcher:
    """A resident template-matching job: the tomogram's spectrum and local
    statistics, the template's ``StaticVolume``, the wedge and the score
    and index maps live on ``device`` (default: the tomogram's, if it is a
    tensor, else ``'cuda'``).

    ``tomogram`` (3-D), ``template`` and ``mask`` (one shape, no larger
    than the tomogram on any axis) are arrays or tensors; the mask must
    be spherical about the template's centre ``n // 2``.  ``tilt_range``,
    ``tilt_axis`` and ``projection_axis`` give the wedge
    (:func:`missing_wedge`); ``interpolation`` the template's rotation."""

    def __init__(self, tomogram, template, mask, *,
                 tilt_range=(-60.0, 60.0), tilt_axis: int = 2,
                 projection_axis: int = 0,
                 interpolation: str = "filt_bspline",
                 device: Optional[str] = None):
        if device is None:
            device = (str(tomogram.device) if isinstance(
                tomogram, torch.Tensor) else "cuda")
        dev = _device(device)
        tomo = _as_tensor(tomogram, dev)
        tmpl = _as_tensor(template, dev)
        mask_t = _as_tensor(mask, dev)
        if tomo.ndim != 3 or tmpl.ndim != 3:
            raise ValueError("expected a 3-D tomogram and a 3-D template")
        if tuple(mask_t.shape) != tuple(tmpl.shape):
            raise ValueError(f"the mask's shape {tuple(mask_t.shape)} is not "
                             f"the template's {tuple(tmpl.shape)}")
        if any(b > s for b, s in zip(tmpl.shape, tomo.shape)):
            raise ValueError(f"the template {tuple(tmpl.shape)} is larger "
                             f"than the tomogram {tuple(tomo.shape)}")
        self.shape = tuple(int(s) for s in tomo.shape)
        self.box = tuple(int(s) for s in tmpl.shape)
        self.centre = tuple(b // 2 for b in self.box)
        _check_spherical(mask_t, self.centre)
        self._n_mask = float(mask_t.to(torch.float64).sum())
        if not self._n_mask > 0:
            raise ValueError("the mask's weights sum to no more than 0")
        self._dev = dev
        self._spectrum, self._inv = _tomogram_terms(
            tomo, mask_t, self.centre, self._n_mask)
        del tomo
        self.wedge = missing_wedge(self.box, tilt_range, tilt_axis,
                                   projection_axis, dev)
        self.sv = StaticVolume(tmpl, interpolation, device=device)
        self._mask = mask_t
        self._place = _placed(tmpl, self.shape, self.centre, reflect=True)
        self._box = torch.empty(self.box, dtype=torch.float32, device=dev)
        self._padded = torch.zeros(self.shape, dtype=torch.float32,
                                   device=dev)
        self._ft = torch.empty_like(self._spectrum)
        self._cc = torch.empty(self.shape, dtype=torch.float32, device=dev)
        self.scores = torch.empty(self.shape, dtype=torch.float32,
                                  device=dev)
        self.indices = torch.empty(self.shape, dtype=torch.int32,
                                   device=dev)
        self.reset()

    def reset(self) -> None:
        """Clear the score and index maps and the orientation counter."""
        self.scores.fill_(-math.inf)
        self.indices.fill_(-1)
        self.orientations = 0

    def match(self, matrices) -> None:
        """Score each of the (N, 4, 4) (or one (4, 4)) host pull-back
        matrices about the template's centre and update the maps.  Queues
        the work on the device and returns without synchronising."""
        ms = np.asarray(matrices, dtype=np.float32)
        if ms.shape == (4, 4):
            ms = ms[None]
        if ms.ndim != 3 or ms.shape[1:] != (4, 4):
            raise ValueError(f"expected (N, 4, 4) matrices, got {ms.shape}")
        with trace.span("match"):
            for m in ms:
                self._score(m, self.orientations)
                self.orientations += 1

    def _score(self, m: np.ndarray, index: int) -> None:
        with trace.span("match.template", device=self._dev):
            t = self._template(m)
            self._padded.view(-1).index_copy_(0, self._place, t.view(-1))
        with trace.span("match.correlate", device=self._dev):
            torch.fft.rfftn(self._padded, out=self._ft)
            self._ft.mul_(self._spectrum)
            torch.fft.irfftn(self._ft, s=self.shape, norm="forward",
                             out=self._cc)
            trace.count("match.transforms", 2)
        with trace.span("match.update", device=self._dev):
            match_update(self._cc, self._inv, self.scores, self.indices,
                         index)
        trace.count("match.orientations")

    def _template(self, m: np.ndarray) -> torch.Tensor:
        """The template rotated by ``m``, through the wedge, normalised
        under the mask and multiplied by it."""
        self.sv.affine(m, output=self._box)
        ft = torch.fft.rfftn(self._box)
        ft.mul_(self.wedge)
        t = torch.fft.irfftn(ft, s=self.box)
        t.sub_((t * self._mask).sum() / self._n_mask)
        var = (t.square() * self._mask).sum() / self._n_mask
        scale = torch.where(var > 0, var.rsqrt(), torch.zeros_like(var))
        return t.mul_(self._mask).mul_(scale)

    def result(self, output: Optional[str] = None
               ) -> Tuple[object, object]:
        """(scores, indices): float32 best scores and the int32 index of the
        orientation that gave each (-1 where none has scored).  ``output``
        None: numpy arrays; ``'device'``: copies on the device, which later
        calls of :meth:`match` leave as they are."""
        if output == "device":
            return self.scores.clone(), self.indices.clone()
        if output is not None:
            raise ValueError(f"output must be None or 'device', got "
                             f"{output!r}")
        return self.scores.cpu().numpy(), self.indices.cpu().numpy()

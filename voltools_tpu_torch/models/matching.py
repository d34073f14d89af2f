"""Template matching: the best local correlation of a rotated template
with a tomogram, voxel by voxel, over a sequence of orientations.

The port's counterpart of pytom-match-pick's GPU matcher
(``pytom_tm/matching.py``; Chaillet et al., Int. J. Mol. Sci. 24:13375,
2023), whose score is Roseman's fast local correlation function
(Ultramicroscopy 94:225, 2003).  The JAX package has no template
matching.

:class:`TemplateMatcher` keeps the tomogram's spectrum, its local
statistics under a spherical mask and the two result maps on the device.  For
each orientation, a 4x4 pull-back matrix about the template's centre
``c = n // 2`` on each axis (as :meth:`StaticVolume.affine` takes it):

1. ``match.template``: the template is rotated by a ``StaticVolume``
   (``filt_bspline`` by default) into a preallocated box; its missing
   wedge is applied, ``irfftn(rfftn(box) * W)``; it is normalised to mean
   0 and standard deviation 1 under the mask ``M`` (weights ``M``,
   ``n = sum(M)``) and multiplied by ``M``; and it is placed with its
   centre at the origin in a zero buffer of its rows at the tomogram's
   width;
2. ``match.correlate``: the ``rfftn`` of the template placed in a
   tomogram-sized zero volume, taken axis by axis on the lines that hold
   it, the product with the tomogram's spectrum, ``irfftn`` (below);
3. ``match.update``: the correlation divided by ``n * sigma_local`` is the
   score; where it is greater than the best so far, the best and the
   orientation's index are replaced, in one pass of the update kernel
   (:mod:`..kernels.match_update`) on the card, which writes only the
   voxels the orientation changes.

A mask that is a function of the distance from the template's centre
(within ``SPHERICAL_TOLERANCE``) is the same under every rotation, so
``sigma_local`` is computed once, at construction.  Any other mask takes
the path of pytom-match-pick's ``--non-spherical-mask``: the mask is
rotated with the template (a second ``StaticVolume``, the template's
interpolation) and the template is normalised under the rotated mask
``M_r`` (``n_r = sum(M_r)``, kept on the device), and between the
correlation and the update a fourth span computes ``sigma_local`` under
``M_r`` anew:

* ``match.sigma``: ``M_r`` placed as the template is, its forward
  transform, the products with the spectra of the normalised tomogram
  ``V`` and of its square (both kept from construction), two
  ``irfftn`` (below): ``N n_r`` times the local mean and mean square under
  ``M_r``; from them the orientation's ``1 / (N n_r sigma)`` map, 0 where
  ``sigma`` is at most ``SIGMA_FLOOR`` of that orientation's largest.
  All of it up to ``mean_sq - mean^2`` is float64 (the spectra kept as
  complex128, the forward in float64 buffers of its own): the difference
  cancels where the tomogram's local ``sigma`` is small against its local
  mean, and float32 transforms' rounding, which scales with the whole
  volume's values, reads there as 0.5% of ``1 / sigma``.  After the
  spectral pass and torch's inverse along y, the C2R along x, ``mean_sq -
  mean^2``, its float32 map, the floor and the reciprocal square root are
  one pass of a hand kernel and an in-place finish on the card, which
  take any width up to ``match_sigma.MAX_WIDTH``
  (:mod:`..kernels.match_sigma`); on the CPU, torch's C2R and plain
  passes, the kernel's plain version.

That is five tomogram-sized transforms an orientation where a spherical
mask takes two.

With ``random_phase_correction`` (pytom-match-pick's
``--random-phase-correction``, after STOPGAP's noise correlation; Wan et
al., Acta Cryst. D 80, 2024), a noise template is made once, at
construction (:func:`phase_randomize_template`: the template's ``rfftn``
amplitudes kept, its phases permuted by ``numpy.random.default_rng(
rng_seed)``), and each orientation scores it beside the template, in two
more spans after ``match.update``:

* ``match.noise``: the noise template through everything the template
  goes through (its own ``StaticVolume``, the template's interpolation;
  the same rotation, wedge, normalisation under the same mask, rotated or
  not, placing, in the template's buffer of rows once its forward has read
  them, and correlation), divided by the same ``n sigma``;
* ``match.noise_update``: one launch of the update kernel's max-only
  entry, ``noise = max(noise, cc_noise / (n sigma))``, a map with no index.

:meth:`TemplateMatcher.result` then returns pytom's final map, the best
scores less the noise map, with the indices unchanged;
:meth:`TemplateMatcher.noise_result` returns the noise map.  That is two
tomogram-sized transforms more an orientation.

The forward transform skips the placed template's zeros: ``rfft`` along x
on the template's ``bz * by`` rows; that copied into the y window of a
zero buffer of the template's ``bz`` planes (its zeros written once, at
construction), ``fft`` along y on them.  The rest of each correlation is
one spectral pass along z (:mod:`..kernels.match_zpass`): for each (y, x')
column it places the planes at the z window, takes the ``fft`` along z,
the product with the spectrum (under a rotated mask, with both spectra)
and the ``ifft`` along z, reading each spectrum once and writing each
result once; torch then takes the inverse along y and the C2R along x.
With y the last c2c pass, the C2R returns the correlation contiguous, as
the update kernel reads it, with no copy; so the pass takes z, and the
spectra are kept laid out as it reads them.  On the card the pass is one
hand kernel, which takes any depth up to ``match_zpass.MAX_POINTS``; on
the CPU it is the kernel's plain version, torch's ``fft``, product and
``ifft`` along z.

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
* A mask that is not spherical is rotated with the template's
  interpolation (``'constant'`` 0), so a ``filt_bspline`` rotation of a
  sharp mask rings, weights below 0 included, as they enter ``n_r`` and
  the moments; ``sigma``'s floor is taken of each orientation's own
  largest ``sigma``; and the moments and ``mean_sq - mean^2`` are
  computed in float64 each orientation, then ``1 / (N n_r sigma)`` in
  float32 (pytom computes all of it in float32).
* Orientations are the caller's matrices, and an index is the position
  of its orientation among those scored since :meth:`reset` (pytom keeps
  the index into its angle list).  The best starts at ``-inf`` and the
  index at ``-1``; a template flat under the mask scores 0.
* The whole tomogram is scored at once, without pytom's split into
  sub-volumes.
* Under the random-phase correction, the noise template is made from the
  template as given, in float64 and kept as float32, and prefiltered
  once for its interpolation;
  its index is the orientation's position, as the template's; and a
  voxel no orientation has scored reads ``-inf`` in the corrected map and
  ``-1`` in the index, not pytom's NaN of ``-inf - -inf``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import match_sigma as sigma_map
from ..kernels import match_zpass as zpass
from ..kernels.match_update import match_noise_update, match_update
from ..transforms import _as_tensor, _device
from ..utils import trace
from ..volume import StaticVolume

__all__ = ["TemplateMatcher", "missing_wedge", "phase_randomize_template"]

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


def phase_randomize_template(template, seed: int = 321) -> np.ndarray:
    """pytom-match-pick's noise template, float64: the ``rfftn`` of
    ``template`` (a 3-D array or tensor), its amplitudes kept and its
    phases, flattened, permuted by ``numpy.random.default_rng(seed)``,
    then ``irfftn`` back to the template's shape.  In numpy, as pytom
    computes it: a frequency whose amplitude is at the transform's
    rounding has that rounding's phase, which the permutation moves onto a
    frequency that matters."""
    if isinstance(template, torch.Tensor):
        template = template.detach().cpu().numpy()
    t = np.asarray(template, np.float64)
    ft = np.fft.rfftn(t)
    phase = np.random.default_rng(seed).permutation(
        np.angle(ft).reshape(-1)).reshape(ft.shape)
    return np.fft.irfftn(np.abs(ft) * np.exp(1j * phase), s=t.shape,
                         axes=(0, 1, 2))


def _is_spherical(mask: torch.Tensor, centre) -> bool:
    """Whether ``mask`` is a function of the distance from ``centre``:
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
    return spread <= SPHERICAL_TOLERANCE * float(values.abs().max())


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


def _normalised(tomogram: torch.Tensor) -> torch.Tensor:
    """The tomogram in float64, brought to mean 0 and standard deviation 1
    (left at mean 0 where it is flat)."""
    v = tomogram.to(torch.float64)
    v = v - v.mean()
    scale = v.square().mean().sqrt()
    if float(scale) > 0:
        v = v / scale
    return v


def _tomogram_spectra(tomogram: torch.Tensor):
    """The spectra of the normalised tomogram and of its square, complex128:
    what a rotated mask's local statistics are correlated with."""
    v = _normalised(tomogram)
    spectrum = torch.fft.rfftn(v)
    return spectrum, torch.fft.rfftn(v.square_())


def _pruned_planes(rows: torch.Tensor, planes: torch.Tensor,
                   y_window: torch.Tensor) -> torch.Tensor:
    """The box placed in ``rows`` (its lines of x, zero elsewhere)
    transformed along x and y on its planes: ``rfft`` along x on the rows,
    into ``y_window`` of ``planes`` (zero elsewhere), ``fft`` along y.
    ``planes`` is laid out y innermost, so the pass along y takes the
    other two axes as one batch, with no copy, and returns y innermost, as
    the spectral pass reads it."""
    planes.index_copy_(1, y_window, torch.fft.rfft(rows, dim=2))
    return torch.fft.fft(planes, dim=1)


def _forward_buffers(box, shape, dtype, device):
    """Zero (rows, planes) buffers of :func:`_pruned_planes` for a ``box``
    in a volume of ``shape``, real ``dtype``."""
    (bz, by, _), (_, height, width) = box, shape
    rows = torch.zeros((bz, by, width), dtype=dtype, device=device)
    return rows, torch.zeros((bz, width // 2 + 1, height),
                             dtype=dtype.to_complex(),
                             device=device).permute(0, 2, 1)


def _spectral_layout(shape, dtype, device) -> torch.Tensor:
    """An empty (Z, Y, X // 2 + 1) spectrum of ``dtype`` laid out x'
    outermost and y innermost, as the spectral pass reads its spectra and
    writes its results: the inverse's pass along y then takes the other
    two axes as one batch, with no copy."""
    depth, height, width = shape
    return torch.empty((width // 2 + 1, depth, height), dtype=dtype,
                       device=device).permute(1, 2, 0)


def _irfft_yx(spectrum: torch.Tensor, shape) -> torch.Tensor:
    """The inverse along y and x, unnormalised, of a spectrum the spectral
    pass inverted along z: ``irfftn`` over the first two axes of its view
    (y, x', z), whose one c2c pass torch runs first and returns y
    innermost, so that the C2R along x returns (Z, Y, X) contiguous, with
    no copy."""
    return torch.fft.irfftn(spectrum.permute(1, 2, 0), s=shape[1:],
                            dim=(0, 1), norm="forward").permute(2, 0, 1)


def _tomogram_terms(tomogram: torch.Tensor, mask: torch.Tensor, centre,
                    n_mask: float):
    """The normalised tomogram's spectrum (complex64) and ``1 / (N n
    sigma)`` (float32, 0 where sigma is under its floor), computed in
    float64."""
    shape = tuple(tomogram.shape)
    v = _normalised(tomogram)
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
    than the tomogram on any axis) are arrays or tensors; the mask's
    weights must sum to more than 0.  A mask spherical about the
    template's centre ``n // 2`` (``spherical`` True) has its local
    statistics computed once; any other is rotated with the template and
    has them recomputed for each orientation (the module's docstring).
    On a CUDA device the tomogram's depth is at most
    ``match_zpass.MAX_POINTS``, the spectral kernel's longest column, and
    under a mask that is not spherical its width at most
    ``match_sigma.MAX_WIDTH``, the sigma kernel's longest row.
    ``tilt_range``, ``tilt_axis`` and ``projection_axis`` give the wedge
    (:func:`missing_wedge`); ``interpolation`` the template's rotation,
    and the mask's.  ``random_phase_correction`` scores a noise template
    made from ``rng_seed`` beside the template each orientation and
    subtracts its running best from the result (pytom-match-pick's
    ``--random-phase-correction`` and ``--rng-seed``; the module's
    docstring)."""

    def __init__(self, tomogram, template, mask, *,
                 tilt_range=(-60.0, 60.0), tilt_axis: int = 2,
                 projection_axis: int = 0,
                 interpolation: str = "filt_bspline",
                 device: Optional[str] = None,
                 random_phase_correction: bool = False,
                 rng_seed: int = 321):
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
        if dev.type == "cuda" and not zpass.supported(self.shape[0], dev):
            raise ValueError(f"the spectral pass takes a depth of at most "
                             f"{zpass.MAX_POINTS} on a CUDA device, got "
                             f"{self.shape[0]}")
        self.centre = tuple(b // 2 for b in self.box)
        self._n_mask = float(mask_t.to(torch.float64).sum())
        if not self._n_mask > 0:
            raise ValueError("the mask's weights sum to no more than 0")
        self.spherical = _is_spherical(mask_t, self.centre)
        if (dev.type == "cuda" and not self.spherical
                and not sigma_map.supported(self.shape[2], dev)):
            raise ValueError(f"under a mask that is not spherical, the sigma "
                             f"kernel takes a width of at most "
                             f"{sigma_map.MAX_WIDTH} on a CUDA device, got "
                             f"{self.shape[2]}")
        self._dev = dev
        if self.spherical:
            spectrum, self._inv = _tomogram_terms(
                tomo, mask_t, self.centre, self._n_mask)
        else:
            spectrum, spectrum_sq = _tomogram_spectra(tomo)
            self._inv = None
            self._mask_sv = StaticVolume(mask_t, interpolation,
                                         device=device)
            self._mask_box = torch.empty(self.box, dtype=torch.float32,
                                         device=dev)
        del tomo
        self.wedge = missing_wedge(self.box, tilt_range, tilt_axis,
                                   projection_axis, dev)
        self.sv = StaticVolume(tmpl, interpolation, device=device)
        self._mask = mask_t
        self._box = torch.empty(self.box, dtype=torch.float32, device=dev)
        # the forward's buffers, zero but on the template's lines
        self._buffers = _forward_buffers(self.box, self.shape, torch.float32,
                                         dev)
        self._rows = self._buffers[0]
        self._place = _placed(tmpl, self._rows.shape, self.centre,
                              reflect=True)
        self._y_window = zpass.window(self.box[1], self.centre[1],
                                      self.shape[1], dev)
        self.noise = None
        if random_phase_correction:
            noise = phase_randomize_template(tmpl, rng_seed)
            self._noise_sv = StaticVolume(
                torch.from_numpy(noise.astype(np.float32)).to(dev),
                interpolation, device=device)
            self.noise = torch.empty(self.shape, dtype=torch.float32,
                                     device=dev)
        # the spectra in the layout the spectral pass reads
        self._spectrum = _spectral_layout(self.shape, torch.complex64,
                                          dev).copy_(spectrum)
        if not self.spherical:
            # the rotated mask's moments: float64 buffers and spectra
            self._wide = _forward_buffers(self.box, self.shape,
                                          torch.float64, dev)
            self._spectrum_wide = _spectral_layout(
                self.shape, torch.complex128, dev).copy_(spectrum)
            self._spectrum_sq_wide = torch.empty_like(
                self._spectrum_wide).copy_(spectrum_sq)
            del spectrum_sq
        del spectrum
        self.scores = torch.empty(self.shape, dtype=torch.float32,
                                  device=dev)
        self.indices = torch.empty(self.shape, dtype=torch.int32,
                                   device=dev)
        self.reset()

    def reset(self) -> None:
        """Clear the score, index and noise maps and the orientation
        counter."""
        self.scores.fill_(-math.inf)
        self.indices.fill_(-1)
        if self.noise is not None:
            self.noise.fill_(-math.inf)
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
        rotated = ()
        with trace.span("match.template", device=self._dev):
            if not self.spherical:
                mask = self._mask_sv.affine(m, output=self._mask_box)
                rotated = (mask, mask.sum())
            self._place_template(m, rotated)
        with trace.span("match.correlate", device=self._dev):
            cc = self._counted_correlation()
        inv = self._inv
        if not self.spherical:
            with trace.span("match.sigma", device=self._dev):
                inv = self._local_inv(*rotated)
                trace.count("match.transforms", 3)
                trace.count("match.pruned_rows", self.box[0] * self.box[1])
                trace.count("match.local_sigma")
                trace.count("match.zpass_products", 2)
        with trace.span("match.update", device=self._dev):
            match_update(cc, inv, self.scores, self.indices, index)
        if self.noise is not None:
            del cc
            # the template's rows again: its forward has read them, in
            # stream order, and the placing writes every placed position
            with trace.span("match.noise", device=self._dev):
                self._place_template(m, rotated, sv=self._noise_sv)
                cc = self._counted_correlation()
                trace.count("match.random_phase")
            with trace.span("match.noise_update", device=self._dev):
                match_noise_update(cc, inv, self.noise)
        trace.count("match.orientations")

    def _place_template(self, m: np.ndarray, rotated=(), **sv) -> None:
        """:meth:`_template` of ``m`` placed in the forward's rows: under
        the ``rotated`` mask and its weight where given, of the volume
        ``sv=`` where given."""
        t = self._template(m, *rotated, **sv)
        self._rows.view(-1).index_copy_(0, self._place, t.view(-1))

    def _counted_correlation(self) -> torch.Tensor:
        """:meth:`_correlation` of the placed template, counted."""
        trace.count("match.transforms", 2)
        trace.count("match.pruned_rows", self.box[0] * self.box[1])
        trace.count("match.zpass_products")
        return self._correlation()

    def _forward(self, buffers=None) -> torch.Tensor:
        """The template in the rows' buffer of ``buffers`` (default: the
        float32 ones) placed in a tomogram-sized zero volume, transformed
        along x and y on the lines that hold it: its planes, which the
        spectral pass takes along z."""
        return _pruned_planes(*(buffers or self._buffers), self._y_window)

    def _products(self, planes: torch.Tensor, *spectra):
        """The spectral pass: ``planes``' forward along z, the product with
        each of ``spectra``, the inverse along z, each into a new tensor
        (:mod:`..kernels.match_zpass`)."""
        outs = tuple(torch.empty_like(s) for s in spectra)
        zpass.match_zpass(planes, spectra, outs, self.centre[0])
        return outs

    def _correlation(self) -> torch.Tensor:
        """The placed template's correlation with the tomogram,
        unnormalised, as a new contiguous float32 tensor."""
        product, = self._products(self._forward(), self._spectrum)
        return _irfft_yx(product, self.shape)

    def _local_inv(self, mask: torch.Tensor, n: torch.Tensor
                   ) -> torch.Tensor:
        """``1 / (N n sigma)`` under the rotated ``mask`` of weight ``n``, 0
        where ``sigma`` is at most ``SIGMA_FLOOR`` of its largest, as a new
        float32 tensor.  The two correlations, float64, are ``N n`` times
        the local mean and mean square, so ``w = N n * mean_sq' - mean'^2``
        is ``(N n sigma)^2``, and the map is ``w``'s reciprocal square
        root: after torch's inverse along y, the C2R along x and the map
        (:mod:`..kernels.match_sigma`: its kernel on the card, its plain
        version on the CPU)."""
        if self._dev.type == "cuda":
            trace.count("match.sigma_pass")
        # sigma > SIGMA_FLOOR * max(sigma) where w > SIGMA_FLOOR^2 * max(w)
        return sigma_map.match_sigma(*self._moments(mask), n, self.shape[2],
                                     SIGMA_FLOOR ** 2)

    def _moments(self, mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The rotated ``mask``'s two correlations, ``N n`` times the local
        mean and mean square, as complex128 spectra along x: the mask
        placed in the float64 rows, its forward, the spectral pass's two
        products and torch's inverse along y, which keeps y innermost."""
        self._wide[0].view(-1).index_copy_(0, self._place,
                                           mask.view(-1).double())
        return tuple(torch.fft.ifft(t, dim=1, norm="forward")
                     for t in self._products(self._forward(self._wide),
                                             self._spectrum_wide,
                                             self._spectrum_sq_wide))

    def _template(self, m: np.ndarray, mask: Optional[torch.Tensor] = None,
                  n=None, sv: Optional[StaticVolume] = None) -> torch.Tensor:
        """The template of ``sv`` (default: the matcher's) rotated by
        ``m``, through the wedge, normalised under ``mask`` of weight ``n``
        (the matcher's mask and its weight by default) and multiplied by
        it."""
        if mask is None:
            mask, n = self._mask, self._n_mask
        (sv or self.sv).affine(m, output=self._box)
        ft = torch.fft.rfftn(self._box)
        ft.mul_(self.wedge)
        t = torch.fft.irfftn(ft, s=self.box)
        t.sub_((t * mask).sum() / n)
        var = (t.square() * mask).sum() / n
        scale = torch.where(var > 0, var.rsqrt(), torch.zeros_like(var))
        return t.mul_(mask).mul_(scale)

    def result(self, output: Optional[str] = None
               ) -> Tuple[object, object]:
        """(scores, indices): float32 best scores and the int32 index of the
        orientation that gave each (-1 where none has scored); with the
        random-phase correction the scores less the noise map (``-inf``
        where none has scored).  ``output`` None: numpy arrays;
        ``'device'``: copies on the device, which later calls of
        :meth:`match` leave as they are."""
        _check_output(output)
        scores = self.scores
        if self.noise is not None:
            scores = torch.where(self.noise == -math.inf, scores,
                                 scores - self.noise)
        elif output == "device":
            scores = scores.clone()
        if output == "device":
            return scores, self.indices.clone()
        return scores.cpu().numpy(), self.indices.cpu().numpy()

    def noise_result(self, output: Optional[str] = None):
        """The float32 noise map: the best score of the noise template at
        each voxel (``-inf`` where none has scored), as :meth:`result`
        gives its maps (``output`` None or ``'device'``).  Only with the
        random-phase correction."""
        _check_output(output)
        if self.noise is None:
            raise ValueError("the matcher runs without "
                             "random_phase_correction: it has no noise map")
        if output == "device":
            return self.noise.clone()
        return self.noise.cpu().numpy()


def _check_output(output) -> None:
    if output is not None and output != "device":
        raise ValueError(f"output must be None or 'device', got {output!r}")

"""A template-matching sweep under a mask that is not spherical, as
pytom-match-pick's ``--non-spherical-mask`` runs it: the sweep of
:mod:`portbench.drivers.template_match` (its traffic keys, window, check
and traced pass), with an ellipsoidal mask and an elongated template, so
that ``TemplateMatcher`` rotates the mask with the template and
recomputes the tomogram's local standard deviation under it for each
orientation.

The config's ``mask`` gives the ellipsoid's ``semi_axes`` (voxels along
array axes 0, 1, 2) and ``edge_sigma``; its ``template`` the blobs'
``spread``, the most their centres lie from the box's centre along each
axis.  The check's reference is :mod:`portbench.reference.matching_nsmask`;
the traced pass also records ``sigma_ms``, the device ms an orientation
under the program's span ``match.sigma``, and the counter
``match.local_sigma``, and takes the least time of an orientation from
:mod:`portbench.roofline.matching_nsmask`.
"""

from __future__ import annotations

import math
import time

import torch

from voltools_tpu_torch.models.matching import TemplateMatcher
from voltools_tpu_torch.utils import trace as program_trace
from portbench import traffic
from portbench.drivers import template_match
from portbench.reference import matching_nsmask as reference
from portbench.roofline import matching_nsmask as roofline


def ellipsoidal_mask(box: int, semi_axes, edge_sigma: float, device):
    """An ellipsoid of ``semi_axes`` along array axes (0, 1, 2) about voxel
    ``box // 2``, 1 inside, with a Gaussian edge of ``edge_sigma`` in the
    distance outside it along the ray from its centre, float32."""
    g = torch.arange(box, dtype=torch.float32, device=device) - box // 2
    axes = [g.view(-1, 1, 1), g.view(1, -1, 1), g.view(1, 1, -1)]
    r = sum(a.square() for a in axes).sqrt()
    e = sum((a / s).square() for a, s in zip(axes, semi_axes)).sqrt()
    # at e > 1 the ray from the centre leaves the ellipsoid at r / e
    outside = r * (1.0 - 1.0 / e.clamp_min(1.0))
    return torch.exp(-0.5 * (outside / edge_sigma).square())


def elongated_blobs(box: int, blobs: int, sigma, spread, gen, device):
    """``blobs`` Gaussian blobs of unit height in a ``box``^3 volume, each
    sigma uniform in ``sigma`` = [lo, hi] voxels, centres uniform within
    ``spread`` voxels of voxel ``box // 2`` along each axis, float32."""
    half = torch.tensor(spread, dtype=torch.float32, device=device)
    centres = box // 2 + half * (2 * torch.rand(
        (blobs, 3), generator=gen, device=device) - 1)
    sigmas = sigma[0] + (sigma[1] - sigma[0]) * torch.rand(
        (blobs,), generator=gen, device=device)
    g = torch.arange(box, dtype=torch.float32, device=device)
    prof = [torch.exp(-0.5 * ((g[None, :] - centres[:, a:a + 1])
                              / sigmas[:, None]) ** 2) for a in range(3)]
    vol = torch.zeros((box,) * 3, dtype=torch.float32, device=device)
    for b in range(blobs):
        vol.addcmul_(prof[0][b].view(-1, 1, 1),
                     prof[1][b].view(1, -1, 1) * prof[2][b].view(1, 1, -1))
    return vol


class Driver(template_match.Driver):
    def setup(self):
        cell, cfg, tr = self.cell, self.cfg, self.tr
        rng, device_gen = traffic.seeded(cell.seed)
        gen = device_gen(cell.device)
        t, mask = cfg["template"], cfg["mask"]
        self.template = elongated_blobs(self.box, t["blobs"], t["sigma"],
                                        t["spread"], gen, cell.device)
        self.mask = ellipsoidal_mask(self.box, mask["semi_axes"],
                                     mask["edge_sigma"], cell.device)
        self.tomogram = self._tomogram(rng, gen)
        self.matcher = TemplateMatcher(
            self.tomogram, self.template, self.mask,
            tilt_range=tuple(cfg["tilt_range_deg"]),
            tilt_axis=cfg["tilt_axis"],
            projection_axis=cfg["projection_axis"],
            interpolation=cfg["interpolation"], device=str(cell.device))
        if self.matcher.spherical:
            raise ValueError("the config's mask is spherical: this cell "
                             "measures the non-spherical path")
        calls = math.ceil(cell.seconds * 1e3 / tr["pool_floor_ms"]
                          / self.per) + 1
        self.pool = self._rotations(rng, calls * self.per).reshape(
            calls, self.per, 4, 4)
        self.checked = self.pool[0].copy()    # the window's first call's
        warm = self._rotations(rng, 4 * self.per).reshape(4, self.per, 4, 4)
        self.replay = self._rotations(
            rng, tr["replay"]["calls"] * self.per).reshape(-1, self.per, 4, 4)
        # warm-up: every shape of the window (the first call's snapshot
        # too), then a timed stretch of calls
        self.matcher.match(warm[0])
        self.kept = self.matcher.result(output="device")
        calls, t0 = 0, time.perf_counter()
        while calls < 1 or time.perf_counter() - t0 < tr["warmup_s"]:
            self.matcher.match(warm[calls % len(warm)])
            calls += 1
        cell.sync()

    def trace(self, record):
        """The sweep's traced pass, and from the same recording the device
        ms an orientation under ``match.sigma``, the counter
        ``match.local_sigma`` and the least time of an orientation that
        recomputes its local statistics."""
        before = program_trace.counts().get("match.local_sigma", 0)
        super().trace(record)
        traced = record["trace"]
        traced["counts"]["match.local_sigma"] = (
            program_trace.counts().get("match.local_sigma", 0) - before)
        export = program_trace.export()
        spent = template_match._device_ms_by_span(export, {"match.sigma"})
        n, per = traced["orientations"], traced["match_ms"]
        if "match.sigma" in spent and n:
            per["sigma_ms"] = spent["match.sigma"] / n
            ops = traced["breakdown"]["device_ops"]
            ops.append(["match.sigma: the rotated mask's forward, two "
                        "products and irfftn, the 1 / (N n sigma) map",
                        spent["match.sigma"] / 1e3])
            ops.sort(key=lambda p: -p[1])
        if "least_ms" in per:
            per["least_ms"] = roofline.orientation_ms(self.shape)[0]

    def _reference(self, dtype=torch.float64):
        cfg = self.cfg
        return reference.match(
            self.tomogram, self.template, self.mask, self.checked,
            tilt_range=tuple(cfg["tilt_range_deg"]),
            tilt_axis=cfg["tilt_axis"],
            projection_axis=cfg["projection_axis"],
            interpolation=cfg["interpolation"], cval=cfg["cval"],
            dtype=dtype)


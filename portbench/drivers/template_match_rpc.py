"""A template-matching sweep with pytom-match-pick's random-phase
correction (``--random-phase-correction --rng-seed``): the sweep of
:mod:`portbench.drivers.template_match` (its traffic keys, window and
traced pass), with ``TemplateMatcher(..., random_phase_correction=True,
rng_seed=...)`` from the config's ``random_phase_correction`` and
``rng_seed``, so that each orientation scores a phase-randomised template
beside the template and keeps its running best.

A program whose ``TemplateMatcher`` takes no such option is refused at
once, before any data is made.

The answers checked are the maps after the window's first call: the
template's best scores and their indices, the noise map and the
corrected map ``result()`` returns, against
:mod:`portbench.reference.matching_rpc`, each map's largest difference
over the largest |reference best score|.  The traced pass also records
``noise_ms`` and ``noise_update_ms``, the device ms an orientation under
the program's spans ``match.noise`` and ``match.noise_update``, the
counter ``match.random_phase``, and the least times of an orientation and
of the noise map's update from :mod:`portbench.roofline.matching_rpc`.
"""

from __future__ import annotations

import inspect
import math
import time

import torch

from voltools_tpu_torch.models.matching import TemplateMatcher
from voltools_tpu_torch.utils import trace as program_trace
from portbench import traffic
from portbench.drivers import _replay, template_match
from portbench.reference import matching_rpc as reference
from portbench.roofline import matching_rpc as roofline

PLANES_A_BLOCK = 64           # the check's difference, a block at a time
NOISE_SPANS = {"match.noise": "noise_ms",
               "match.noise_update": "noise_update_ms"}


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in float64, a block of planes at a time."""
    worst = 0.0
    for z in range(0, want.shape[0], PLANES_A_BLOCK):
        diff = float((got[z:z + PLANES_A_BLOCK].to(torch.float64)
                      - want[z:z + PLANES_A_BLOCK]).abs().max())
        if math.isnan(diff):
            return math.nan
        worst = max(worst, diff)
    return worst


class Driver(template_match.Driver):
    def setup(self):
        if "random_phase_correction" not in inspect.signature(
                TemplateMatcher).parameters:
            raise TypeError("this program's TemplateMatcher has no "
                            "random_phase_correction option")
        cell, cfg, tr = self.cell, self.cfg, self.tr
        rng, device_gen = traffic.seeded(cell.seed)
        gen = device_gen(cell.device)
        t = cfg["template"]
        self.template = traffic.blob_phantom(
            (self.box,) * 3, t["blobs"], t["sigma"], t["region"], gen,
            cell.device)
        self.mask = template_match.spherical_mask(
            self.box, cfg["mask"]["radius"], cfg["mask"]["edge_sigma"],
            cell.device)
        self.tomogram = self._tomogram(rng, gen)
        self.matcher = TemplateMatcher(
            self.tomogram, self.template, self.mask,
            tilt_range=tuple(cfg["tilt_range_deg"]),
            tilt_axis=cfg["tilt_axis"],
            projection_axis=cfg["projection_axis"],
            interpolation=cfg["interpolation"], device=str(cell.device),
            random_phase_correction=cfg["random_phase_correction"],
            rng_seed=cfg["rng_seed"])
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
        self.kept = self._snapshot()
        calls, t0 = 0, time.perf_counter()
        while calls < 1 or time.perf_counter() - t0 < tr["warmup_s"]:
            self.matcher.match(warm[calls % len(warm)])
            calls += 1
        cell.sync()

    def _snapshot(self):
        """(best scores, indices, noise map, corrected map), copies on the
        device."""
        matcher = self.matcher
        corrected, indices = matcher.result(output="device")
        return (matcher.scores.clone(), indices,
                matcher.noise_result(output="device"), corrected)

    def window(self):
        cell, matcher, pool = self.cell, self.matcher, self.pool
        matcher.reset()
        peak_setup = _replay.reset_peak(cell)
        cell.sync()
        t0 = time.perf_counter()
        deadline = t0 + cell.seconds
        i = 0
        # the pool holds more orientations than the window's seconds at
        # the function's least time: a program that gets through it has
        # not done the work, and its answers show it
        while i < len(pool):
            matcher.match(pool[i])
            if i == 0:
                self.kept = self._snapshot()
            i += 1
            if time.perf_counter() >= deadline:
                break
        cell.sync()
        t1 = time.perf_counter()
        peak_window = _replay.peak(cell)
        return {"t0": t0, "window_s": t1 - t0, "completed": i * self.per,
                "peak_bytes": max(peak_setup, peak_window),
                "peak_window_bytes": peak_window}

    def trace(self, record):
        """The sweep's traced pass, and from the same recording the device
        ms an orientation under ``match.noise`` and
        ``match.noise_update``, the counter ``match.random_phase``, and the
        least times of an orientation and of the noise map's update."""
        before = program_trace.counts().get("match.random_phase", 0)
        super().trace(record)
        traced = record["trace"]
        traced["counts"]["match.random_phase"] = (
            program_trace.counts().get("match.random_phase", 0) - before)
        export = program_trace.export()
        spent = template_match._device_ms_by_span(export, set(NOISE_SPANS))
        n, per = traced["orientations"], traced["match_ms"]
        labels = {"match.noise": "match.noise: the noise template's "
                  "rotation, wedge, normalisation, placing and correlation",
                  "match.noise_update": "match.noise_update: the noise "
                  "map's running best"}
        ops = traced["breakdown"]["device_ops"]
        for name, key in NOISE_SPANS.items():
            if name in spent and n:
                per[key] = spent[name] / n
                ops.append([labels[name], spent[name] / 1e3])
        ops.sort(key=lambda p: -p[1])
        if "noise_update_ms" in per:
            per["noise_update_least_ms"] = roofline.noise_update_ms(
                self.shape)[0]
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
            rng_seed=cfg["rng_seed"], dtype=dtype)

    def check(self):
        """``max_rel_err``, ``noise_max_rel_err`` and
        ``corrected_max_rel_err``: the largest difference of the best,
        noise and corrected maps from the reference's, each over the
        largest |reference best score|; and ``index_mismatch``, as the
        sweep without the correction counts it."""
        limits = self.cell.limits
        best, index, second, noise, corrected = self._reference()
        scores, indices, got_noise, got_corrected = self.kept
        scale = float(best.abs().max())
        compared = {
            "max_rel_err": max_abs_diff(scores, best) / scale,
            "noise_max_rel_err": max_abs_diff(got_noise, noise) / scale,
            "corrected_max_rel_err":
                max_abs_diff(got_corrected, corrected) / scale}
        del noise, corrected
        clear = (best - second) > 10 * limits["max_rel_err"]
        wrong = (indices.to(torch.int64) != index) & clear
        compared["index_mismatch"] = (float(wrong.sum())
                                      / max(1, int(clear.sum())))
        failed = not all(v <= limits[k] for k, v in compared.items())
        return {"compared": compared, "failed": int(failed), "answers": 1}

"""A tilt-series projection sweep: one caller reprojects one resident
tomogram over a fresh single-axis tilt series a call, through a projector
of each of ``interpolations`` in turn, back to back, as users who reproject
a tomogram to refine a tilt series' alignment or to simulate a series do
(``examples/torch_projections.py``).

Each projector is a ``TiltSeriesProjector`` made at set-up on the config's
seeded phantom (``'rzxz'``, ``projection_axis``, ``mode``; a cubic one
prefiltered there); a call is ``project(angles, tilt_axis=..., output=
'device')`` on each.  Each call's angles are the tilts ``tilt_range_deg``
in ``tilt_step_deg`` steps, all offset by one seeded angle uniform in
+-``series_offset_deg``; ``tilt_axis`` 0 puts the angle at position 0 of
'rzxz', a tilt about array axis 2.  Traffic keys besides: ``sample``, the
projections checked of each projector; ``warmup_s`` of calls; a pool of
series that no window can use up (``pool_floor_ms``, below the least time
of a projection; a window that does use it up ends there); ``replay``
(``calls``, ``rounds``, ``sleep_ms``, ``events``) for the traced run, as
the rotation sweeps take it.

The answers checked are ``sample`` projections of each projector from the
window's first call, drawn from the seed, against the float64 reference:
:mod:`portbench.reference.resample`'s transform through the tilt's matrix
(:func:`portbench.traffic.tilt_series`), summed along the projection axis.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from voltools_tpu_torch import transforms
from voltools_tpu_torch.models import TiltSeriesProjector
from portbench import timing, traffic
from portbench.drivers import _replay
from portbench.reference import resample as reference
from portbench.reference import rounder


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config
        self.tr = cell.traffic
        self.shape = tuple(int(s) for s in self.cfg["shape"])
        self.axis = int(self.cfg["projection_axis"])
        lo, hi = self.tr["tilt_range_deg"]
        step = self.tr["tilt_step_deg"]
        self.tilts = np.arange(lo, hi + step / 2, step)
        if self.tr["tilt_axis"] != 0:
            raise ValueError("the reference's series is 'rzxz' with the "
                             "angle at position 0: tilt_axis must be 0")

    def _series(self, rng: np.random.Generator, calls: int) -> np.ndarray:
        """``calls`` fresh series of angles, (calls, tilts) degrees."""
        offset = self.tr["series_offset_deg"]
        return self.tilts + rng.uniform(-offset, offset, (calls, 1))

    def setup(self):
        cell, cfg, tr = self.cell, self.cfg, self.tr
        rng, device_gen = traffic.seeded(cell.seed)
        ph = cfg["phantom"]
        self.volume = traffic.blob_phantom(
            self.shape, ph["blobs"], ph["sigma"], ph["region"],
            device_gen(cell.device), cell.device)
        self.projectors = [
            TiltSeriesProjector(self.volume, interp,
                                projection_axis=self.axis,
                                rotation_order="rzxz",
                                device=str(cell.device), mode=cfg["mode"])
            for interp in tr["interpolations"]]
        per_call = len(self.tilts) * len(self.projectors)
        calls = math.ceil(cell.seconds * 1e3 / tr["pool_floor_ms"]
                          / per_call) + 1
        self.pool = self._series(rng, calls)
        self.checked = self.pool[0].copy()    # the window's first call's
        warm = self._series(rng, 2)
        replay = tr["replay"]
        self.replay_angles = self._series(rng, replay["calls"]
                                          * replay["rounds"])
        self.sample = sorted(int(i) for i in rng.choice(
            len(self.tilts), tr["sample"], replace=False))
        # warm-up: a call and the snapshot's copies, then a timed stretch
        # of calls
        self.kept = self._snapshot(self._call(warm[0])())
        cell.sync()
        if cell.trace:
            _replay.warm(cell, [self._call(a) for a in self.replay_angles[
                :replay["calls"]]], replay["sleep_ms"])
        n, t0 = 0, time.perf_counter()
        while n < 1 or time.perf_counter() - t0 < tr["warmup_s"]:
            self._call(warm[n % len(warm)])()
            n += 1
        cell.sync()

    def _call(self, angles):
        tilt_axis = self.tr["tilt_axis"]
        return lambda: [p.project(angles, tilt_axis=tilt_axis,
                                  output="device") for p in self.projectors]

    def _snapshot(self, stacks):
        """The sampled projections of each stack, copies on the device."""
        return [stack[i].clone() for stack in stacks for i in self.sample]

    def window(self):
        cell, pool = self.cell, self.pool
        peak_setup = _replay.reset_peak(cell)
        cell.sync()
        t0 = time.perf_counter()
        deadline = t0 + cell.seconds
        i = 0
        # the pool holds more series than the window's seconds at the
        # least time of a projection: a program that gets through it has
        # not done the work, and its answers show it
        while i < len(pool):
            stacks = self._call(pool[i])()
            if i == 0:
                self.kept = self._snapshot(stacks)
            del stacks
            i += 1
            if time.perf_counter() >= deadline:
                break
        cell.sync()
        t1 = time.perf_counter()
        peak_window = _replay.peak(cell)
        return {"t0": t0, "window_s": t1 - t0,
                "completed": i * len(self.tilts) * len(self.projectors),
                "peak_bytes": max(peak_setup, peak_window),
                "peak_window_bytes": peak_window}

    def trace(self, record):
        """Per-layer spans over replayed calls, as the rotation sweeps take
        them: host spans of the API (``TiltSeriesProjector.project``) and
        the planner (``transforms.route``, ``transforms.walk_patch``),
        device spans of each kernel launch with its least time, and the
        calls' busy time queued behind a sleep against their wall time
        called live; the rest of the busy time is the stack sums."""
        cell, tr = self.cell, self.tr
        spans = timing.Spans()

        def note(args, kwargs):
            vol, mats, order = args[0], args[1], args[2]
            return (order, tuple(vol.shape), mats)

        patches = [(transforms, "route", "planner", False, None),
                   (transforms, "walk_patch", "planner", False, None),
                   (transforms, "affine_resample", "kernel_a", True, note),
                   (transforms, "affine_slab", "kernel_b", True, note)]
        calls = tr["replay"]["calls"]
        rounds = [[self._call(a) for a in self.replay_angles[
            r * calls:(r + 1) * calls]] for r in range(tr["replay"]["rounds"])]
        trace = _replay.replay(cell, rounds, spans, patches, tr["replay"],
                               sync_each=False)
        inside = {}
        trace["least_ms"] = {k: [_replay.resample_least_ms(
            *n, self.cfg["mode"], cell.device, inside)
            for n in spans.notes[k]] for k in ("kernel_a", "kernel_b")}
        kernels = [(f"kernel {k[-1].upper()} ({n})",
                    _replay.device_total_s(trace, k))
                   for k, n in (("kernel_a", "affine_resample"),
                                ("kernel_b", "affine_slab"))]
        trace["breakdown"] = _replay.breakdown(
            trace, kernels, "the stack sums and matrix uploads", {
                "api": "TiltSeriesProjector.project",
                "planner": "route and walk_patch",
                "kernel_a": "affine_resample wrapper",
                "kernel_b": "affine_slab wrapper"})
        record["trace"] = trace

    def release(self):
        """Free the program's state; the phantom and the sampled
        projections stay for the check."""
        del self.projectors, self.pool
        if self.cell.cuda:
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64):
        """The reference's sampled projections of the first call, in
        ``dtype``, in the order of :meth:`answers`."""
        q = rounder(dtype)
        ms = traffic.tilt_series(self.checked[self.sample], self.shape)
        for interp in self.tr["interpolations"]:
            coef = (reference.prefilter(self.volume, dtype)
                    if interp == "filt_bspline" else None)
            for m in ms:
                rotated = reference.transform(self.volume, m, interp, 0.0,
                                              dtype, coefficients=coef)
                yield q(rotated.sum(dim=self.axis))
            del coef

    def answers(self):
        return self.kept

    def check(self):
        return _replay.compare(self.cell,
                               zip(self.answers(), self.reference()))

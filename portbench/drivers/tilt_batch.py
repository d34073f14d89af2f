"""A batched tilt-series sweep: one caller resamples one resident volume
through a whole single-axis tilt series a ``StaticVolume.affine_batch(ms,
output='device')`` call, back to back, as tomography simulators and
reprojection-based alignment refinement reproject a volume over a tilt
series with per-tilt shifts.

Each call is a fresh series (:func:`portbench.traffic.tilt_series`, about
array axis 2): the tilts ``tilt_range_deg`` in ``tilt_step_deg`` steps,
all offset by one seeded angle uniform in +-``series_offset_deg``, each
shifted by a seeded translation uniform in +-``shift_voxels`` along axes
0 and 1 and none along axis 2.  Every matrix so leaves array axis 2
alone, and the planner routes each launch to the slab kernel's row path.
The other traffic keys (``interpolation``, ``warmup_s``, ``sample``,
``pool_floor_ms``, a tilt's, and ``replay``), the window, the traced
spans, the release and the check are the batched rotation sweep's
(:mod:`portbench.drivers.rotation_batch`), with ``batch`` the tilts of a
series.
"""

from __future__ import annotations

import math
import time

import numpy as np

import voltools_tpu_torch as vt
from portbench import traffic
from portbench.drivers import _replay, rotation_batch


class Driver(rotation_batch.Driver):
    def _series(self, rng: np.random.Generator, calls: int) -> np.ndarray:
        """``calls`` fresh tilt series, (calls, tilts, 4, 4) float32."""
        tr = self.tr
        lo, hi = tr["tilt_range_deg"]
        tilts = np.arange(lo, hi + tr["tilt_step_deg"] / 2,
                          tr["tilt_step_deg"])
        if len(tilts) != self.batch:
            raise ValueError(f"the series has {len(tilts)} tilts, the "
                             f"traffic's batch is {self.batch}")
        offset = rng.uniform(-tr["series_offset_deg"],
                             tr["series_offset_deg"], (calls, 1))
        ms = traffic.tilt_series((tilts + offset).reshape(-1),
                                 self.shape).astype(np.float64)
        shift = tr["shift_voxels"]
        ms[:, :2, 3] += rng.uniform(-shift, shift, (len(ms), 2))
        return ms.astype(np.float32).reshape(calls, self.batch, 4, 4)

    def setup(self):
        cell, cfg, tr = self.cell, self.cfg, self.tr
        batch = self.batch = int(tr["batch"])
        rng, device_gen = traffic.seeded(cell.seed)
        ph = cfg["phantom"]
        self.volume = traffic.blob_phantom(
            self.shape, ph["blobs"], ph["sigma"], ph["region"],
            device_gen(cell.device), cell.device)
        self.sv = vt.StaticVolume(self.volume, tr["interpolation"],
                                  device=str(cell.device), mode=cfg["mode"],
                                  cval=cfg["cval"])
        calls = math.ceil(cell.seconds * 1e3 / tr["pool_floor_ms"]
                          / batch) + 1
        self.pool = self._series(rng, calls)
        warm = self._series(rng, 4)
        replay = tr["replay"]
        self.replay_ms = self._series(rng, replay["calls"]
                                      * replay["rounds"])
        self.out = None          # no output buffer: each call makes its stack
        # warm-up: a call and a sampled tilt's copy, then a timed stretch
        # of calls
        self.sv.affine_batch(warm[0], output="device")[0].clone()
        cell.sync()
        if cell.trace:
            _replay.warm(cell, [self._call(m) for m in self.replay_ms[
                :replay["calls"]]], replay["sleep_ms"])
        n, t0 = 0, time.perf_counter()
        while n < 1 or time.perf_counter() - t0 < tr["warmup_s"]:
            self.sv.affine_batch(warm[n % len(warm)], output="device")
            n += 1
        cell.sync()
        rate = n * batch / (time.perf_counter() - t0)
        # the tilts checked: a sample drawn from the seed among those that
        # the window is sure to reach
        reach = min(self.pool.shape[0] * batch,
                    max(tr["sample"], int(0.8 * rate * cell.seconds)))
        self.sample = traffic.sample_indices(rng, tr["sample"], reach)
        self.sample_ms = self.pool.reshape(-1, 4, 4)[self.sample].copy()

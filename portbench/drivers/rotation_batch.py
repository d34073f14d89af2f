"""A batched rotation sweep: one caller rotates one resident volume through
fresh matrices, ``batch`` of them a ``StaticVolume.affine_batch(ms,
output='device')`` call, back to back, as a caller that scores a batch of
orientations a call drives it.

Traffic keys: ``interpolation``; ``batch``; ``warmup_s`` of calls;
``sample``, the rotations checked; a pool of matrices that no window can
use up (``pool_floor_ms``, below the least time of a rotation; a window
that does use it up ends there); ``replay`` (``calls``, ``rounds``,
``sleep_ms``, ``events``) for the traced run, in calls of ``batch``.
The traced spans, the release and the check are the single-rotation
sweep's (:mod:`portbench.drivers.rotation_sweep`).
"""

from __future__ import annotations

import math
import time

import voltools_tpu_torch as vt
from portbench import traffic
from portbench.drivers import _replay, rotation_sweep


class Driver(rotation_sweep.Driver):
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
        self.pool = traffic.rotation_pool(
            rng, calls * batch, self.shape).reshape(calls, batch, 4, 4)
        warm = traffic.rotation_pool(rng, 4 * batch, self.shape).reshape(
            4, batch, 4, 4)
        replay = tr["replay"]
        self.replay_ms = traffic.rotation_pool(
            rng, replay["calls"] * replay["rounds"] * batch,
            self.shape).reshape(-1, batch, 4, 4)
        self.out = None          # no output buffer: each call makes its stack
        # warm-up: a call and a sampled rotation's copy, then a timed
        # stretch of calls
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
        # the rotations checked: a sample drawn from the seed among those
        # that the window is sure to reach
        reach = min(self.pool.shape[0] * batch,
                    max(tr["sample"], int(0.8 * rate * cell.seconds)))
        self.sample = traffic.sample_indices(rng, tr["sample"], reach)
        self.sample_ms = self.pool.reshape(-1, 4, 4)[self.sample].copy()

    def _call(self, ms):
        return lambda: self.sv.affine_batch(ms, output="device")

    def window(self):
        cell, sv, pool, batch = self.cell, self.sv, self.pool, self.batch
        wanted = {}
        for i in self.sample:
            wanted.setdefault(i // batch, []).append(i % batch)
        last = self.sample[-1] // batch
        kept = []
        peak_setup = _replay.reset_peak(cell)
        cell.sync()
        t0 = time.perf_counter()
        deadline = t0 + cell.seconds
        i = 0
        while i < len(pool):
            out = sv.affine_batch(pool[i], output="device")
            kept += [out[j].clone() for j in wanted.get(i, ())]
            del out
            i += 1
            if i > last and time.perf_counter() >= deadline:
                break
        cell.sync()
        t1 = time.perf_counter()
        peak_window = _replay.peak(cell)
        self.kept = kept
        return {"t0": t0, "window_s": t1 - t0, "completed": i * batch,
                "peak_bytes": max(peak_setup, peak_window),
                "peak_window_bytes": peak_window}

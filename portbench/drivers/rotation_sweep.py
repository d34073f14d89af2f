"""A rotation sweep: one caller rotates one resident volume through fresh
matrices back to back, each into a preallocated device output, as
template matching drives ``StaticVolume`` (upstream ``static_vol_out``).

Traffic keys: ``interpolation``; ``warmup_s`` of calls over
``warmup_matrices`` matrices; ``sample``, the answers checked; a pool of
matrices that no window can use up (``pool_floor_ms``, below the least
time of a rotation; a window that does use it up ends there); ``replay``
(``calls``, ``rounds``, ``sleep_ms``, ``events``) for the traced run.
"""

from __future__ import annotations

import math
import time

import torch

import voltools_tpu_torch as vt
from voltools_tpu_torch import transforms
from portbench import timing, traffic
from portbench.drivers import _replay
from portbench.reference import resample as reference


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config
        self.tr = cell.traffic
        self.shape = tuple(int(s) for s in self.cfg["shape"])

    def setup(self):
        cell, cfg, tr = self.cell, self.cfg, self.tr
        rng, device_gen = traffic.seeded(cell.seed)
        ph = cfg["phantom"]
        self.volume = traffic.blob_phantom(
            self.shape, ph["blobs"], ph["sigma"], ph["region"],
            device_gen(cell.device), cell.device)
        self.sv = vt.StaticVolume(self.volume, tr["interpolation"],
                                  device=str(cell.device), mode=cfg["mode"],
                                  cval=cfg["cval"])
        n_pool = math.ceil(cell.seconds * 1e3 / tr["pool_floor_ms"]) + 1
        self.pool = traffic.rotation_pool(rng, n_pool, self.shape)
        self.warm = traffic.rotation_pool(rng, tr["warmup_matrices"],
                                          self.shape)
        replay = tr["replay"]
        self.replay_ms = traffic.rotation_pool(
            rng, replay["calls"] * replay["rounds"], self.shape)
        self.out = torch.empty(self.shape, dtype=torch.float32,
                               device=cell.device)
        self.kept = [torch.empty_like(self.out)
                     for _ in range(tr["sample"])]
        # warm-up: every output buffer, then a timed stretch of calls
        for i, buf in enumerate(self.kept + [self.out]):
            self.sv.affine(self.warm[i % len(self.warm)], output=buf)
        cell.sync()
        if cell.trace:
            _replay.warm(cell, [self._call(m) for m in self.replay_ms[
                :replay["calls"]]], replay["sleep_ms"])
        calls, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < tr["warmup_s"]:
            self.sv.affine(self.warm[calls % len(self.warm)],
                           output=self.out)
            calls += 1
        cell.sync()
        rate = calls / (time.perf_counter() - t0)
        # the answers checked: a sample drawn from the seed among the calls
        # that the window is sure to reach
        reach = min(len(self.pool),
                    max(len(self.kept), int(0.8 * rate * cell.seconds)))
        self.sample = traffic.sample_indices(rng, len(self.kept), reach)
        self.sample_ms = self.pool[self.sample].copy()

    def _call(self, m):
        return lambda: self.sv.affine(m, output=self.out)

    def window(self):
        cell, sv, pool, out = self.cell, self.sv, self.pool, self.out
        slot = {i: buf for i, buf in zip(self.sample, self.kept)}
        peak_setup = _replay.reset_peak(cell)
        cell.sync()
        t0 = time.perf_counter()
        deadline = t0 + cell.seconds
        last = self.sample[-1]
        i = 0
        # the pool holds more rotations than the window's seconds at the
        # function's least time: a program that gets through it has not
        # done the work, and its answers show it
        while i < len(pool):
            sv.affine(pool[i], output=slot.get(i, out))
            i += 1
            if i > last and time.perf_counter() >= deadline:
                break
        cell.sync()
        t1 = time.perf_counter()
        peak_window = _replay.peak(cell)
        return {"t0": t0, "window_s": t1 - t0, "completed": i,
                "peak_bytes": max(peak_setup, peak_window),
                "peak_window_bytes": peak_window}

    def trace(self, record):
        """Per-layer spans over replayed calls: host spans of the API
        (``StaticVolume.affine``) and the planner (``transforms.route``,
        ``transforms.walk_patch``), device spans of each kernel launch,
        and the calls' busy time queued behind a sleep against their wall
        time called live."""
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
        rounds = [[self._call(m) for m in self.replay_ms[r * calls:
                                                          (r + 1) * calls]]
                  for r in range(tr["replay"]["rounds"])]
        trace = _replay.replay(cell, rounds, spans, patches,
                               tr["replay"], sync_each=False)
        inside = {}
        trace["least_ms"] = {k: [_replay.resample_least_ms(
            *n, self.cfg["mode"], cell.device, inside)
            for n in spans.notes[k]] for k in ("kernel_a", "kernel_b")}
        kernels = [(f"kernel {k[-1].upper()} ({n})",
                    _replay.device_total_s(trace, k))
                   for k, n in (("kernel_a", "affine_resample"),
                                ("kernel_b", "affine_slab"))]
        trace["breakdown"] = _replay.breakdown(
            trace, kernels, "matrix uploads", {
                "api": "StaticVolume.affine",
                "planner": "route and walk_patch",
                "kernel_a": "affine_resample wrapper",
                "kernel_b": "affine_slab wrapper"})
        record["trace"] = trace

    def release(self):
        """Free the program's state; the phantom and the sampled answers
        stay for the check."""
        del self.sv, self.out, self.pool
        if self.cell.cuda:
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64):
        """The reference's answer to each sampled call, in ``dtype``."""
        interp = self.tr["interpolation"]
        coef = (reference.prefilter(self.volume, dtype)
                if interp == "filt_bspline" else None)
        for m in self.sample_ms:
            yield reference.transform(self.volume, m, interp,
                                      self.cfg["cval"], dtype,
                                      coefficients=coef)

    def answers(self):
        return self.kept

    def check(self):
        return _replay.compare(self.cell,
                               zip(self.answers(), self.reference()))

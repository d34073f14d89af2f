"""A closed loop of reconstructions: one caller reconstructs tilt series
back to back, each call ending in a synchronize because the user waits
for the volume (``output='device'``).

Traffic keys: ``entry`` ('sirt' with ``iterations`` and ``relax``, or
'wbp' with ``filter``); ``stacks`` distinct tilt series, made at set-up
(the reference's projections of one phantom, each with its own noise) and
called in turn; ``warmup_s`` of calls; ``sample``, the answers checked;
``replay`` (``calls``, ``rounds``, ``sleep_ms``, ``events``) for the
traced run.
The config gives the volume, the tilt series and the phantom.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from voltools_tpu_torch import transforms
from voltools_tpu_torch.models import reconstruction
from portbench import roofline, timing, traffic
from portbench.drivers import _replay
from portbench.reference import rounder, tomography


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config
        self.tr = cell.traffic
        self.shape = tuple(int(s) for s in self.cfg["shape"])
        lo, hi, step = self.cfg["tilts_deg"]
        self.matrices = traffic.tilt_series(
            np.arange(lo, hi + step / 2, step), self.shape)
        self.inside = {}

    def _series(self, dtype=torch.float64):
        return tomography.TiltSeries(self.matrices, self.shape,
                                     self.cell.device,
                                     q=rounder(dtype))

    def setup(self):
        cell, cfg, tr = self.cell, self.cfg, self.tr
        rng, device_gen = traffic.seeded(cell.seed)
        gen = device_gen(cell.device)
        ph = cfg["phantom"]
        self.phantom = traffic.blob_phantom(
            self.shape, ph["blobs"], ph["sigma"], ph["region"], gen,
            cell.device)
        clean = self._series().project(self.phantom)
        sigma = cfg["noise"] * float(clean.mean())
        self.stacks = [
            (clean + sigma * torch.randn(clean.shape, generator=gen,
                                         dtype=torch.float64,
                                         device=cell.device)).float()
            for _ in range(tr["stacks"])]
        del clean
        if cell.cuda:
            torch.cuda.empty_cache()
        # warm-up: as many answers held as the window holds, then a timed
        # stretch of calls
        held = [self._call(k % len(self.stacks))()
                for k in range(tr["sample"] + 1)]
        cell.sync()
        del held
        if cell.trace:
            _replay.warm(cell, [self._call(0)] * tr["replay"]["calls"],
                         tr["replay"]["sleep_ms"])
        calls, t0 = 0, time.perf_counter()
        while calls < 1 or time.perf_counter() - t0 < tr["warmup_s"]:
            self._call(calls % len(self.stacks))()
            cell.sync()
            calls += 1
        per_call = (time.perf_counter() - t0) / calls
        reach = max(tr["sample"], int(0.8 * cell.seconds / per_call))
        self.sample = traffic.sample_indices(rng, tr["sample"], reach)

    def _call(self, k):
        projs, ms, shape, tr = self.stacks[k], self.matrices, self.shape, \
            self.tr
        if tr["entry"] == "sirt":
            return lambda: reconstruction.sirt_reconstruct(
                projs, ms, shape, iterations=tr["iterations"],
                relax=tr["relax"], device=str(self.cell.device),
                output="device")
        return lambda: reconstruction.wbp_reconstruct(
            projs, ms, shape, filter_window=tr["filter"],
            device=str(self.cell.device), output="device")

    def window(self):
        cell, n = self.cell, len(self.stacks)
        calls = [self._call(k) for k in range(n)]
        wanted = set(self.sample)
        self.kept = []
        latencies = []
        peak_setup = _replay.reset_peak(cell)
        cell.sync()
        t0 = time.perf_counter()
        deadline = t0 + cell.seconds
        last = self.sample[-1]
        i = 0
        while True:
            t = time.perf_counter()
            out = calls[i % n]()
            cell.sync()
            done = time.perf_counter()
            latencies.append((done - t) * 1e3)
            if i in wanted:
                self.kept.append((i % n, out))
            del out
            i += 1
            if i > last and done >= deadline:
                break
        t1 = time.perf_counter()
        peak_window = _replay.peak(cell)
        return {"t0": t0, "window_s": t1 - t0, "completed": i,
                "latencies_ms": latencies,
                "peak_bytes": max(peak_setup, peak_window),
                "peak_window_bytes": peak_window}

    def trace(self, record):
        """Per-layer spans over replayed calls: the API's host span, device
        spans of the forward sweep (``project_stack``), of kernels A, B
        and C, and the calls' busy time queued behind a sleep against
        their wall time called live, each call synchronized."""
        cell, tr = self.cell, self.tr

        def resample_note(args, kwargs):
            vol, mats, order = args[0], args[1], args[2]
            return ("resample", order, tuple(vol.shape), mats)

        def backproject_note(args, kwargs):
            projs, minv, keep, out_shape = args[:4]
            rowgather = args[4] if len(args) > 4 else kwargs.get("rowgather")
            return ("backproject", len(projs), tuple(out_shape),
                    tuple(projs.shape[1:]), bool(rowgather))

        patches = [
            (reconstruction, "project_stack", "forward", True, None),
            (reconstruction, "backproject", "kernel_c", True,
             backproject_note),
            (transforms, "route", "planner", False, None),
            (transforms, "walk_patch", "planner", False, None),
            (transforms, "affine_resample", "kernel_a", True, resample_note),
            (transforms, "affine_slab", "kernel_b", True, resample_note)]
        per = tr["replay"]["calls"]
        rounds = [[self._call((r * per + c) % len(self.stacks))
                   for c in range(per)]
                  for r in range(tr["replay"]["rounds"])]
        spans = timing.Spans()
        trace = _replay.replay(cell, rounds, spans, patches,
                               tr["replay"], sync_each=True)
        trace["least_ms"] = {k: [self._least(n) for n in spans.notes[k]]
                             for k in ("kernel_a", "kernel_b", "kernel_c")}
        trace["forward_calls"] = len(trace["device_ms"].get("forward", []))
        dev = {k: _replay.device_total_s(trace, k)
               for k in ("forward", "kernel_a", "kernel_b", "kernel_c")}
        rest = ("the rest of the call: the normalisers and the updates"
                if tr["entry"] == "sirt" else
                "the rest of the call: the ramp filter and the scale")
        trace["breakdown"] = _replay.breakdown(trace, [
            ("kernel B (affine_slab), the forward's chunks", dev["kernel_b"]),
            ("kernel A (affine_resample), the forward's chunks",
             dev["kernel_a"]),
            ("the forward less its kernels: the stack sums",
             dev["forward"] - dev["kernel_a"] - dev["kernel_b"]),
            ("kernel C (backproject)", dev["kernel_c"])], rest,
            {"api": f"{tr['entry']}_reconstruct",
             "planner": "route and walk_patch",
             "kernel_a": "affine_resample wrapper",
             "kernel_b": "affine_slab wrapper",
             "kernel_c": "backproject wrapper"})
        record["trace"] = trace

    def _least(self, n):
        if n[0] == "backproject":
            return roofline.backproject_launch_ms(*n[1:])[0]
        return _replay.resample_least_ms(*n[1:], self.cfg["mode"],
                                         self.cell.device, self.inside)

    def release(self):
        """Nothing of the program's is held but the sampled answers."""
        if self.cell.cuda:
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64):
        """The reference's answer to each sampled call, in ``dtype``: one
        reconstruction per distinct tilt series among them."""
        series = self._series(dtype)
        done = {}
        for k, _ in self.kept:
            if k not in done:
                if self.tr["entry"] == "sirt":
                    done[k] = tomography.sirt(series, self.stacks[k],
                                              self.tr["iterations"],
                                              self.tr["relax"])
                else:
                    done[k] = tomography.wbp(series, self.stacks[k])
            yield done[k]

    def answers(self):
        return [out for _, out in self.kept]

    def check(self):
        return _replay.compare(self.cell,
                               zip(self.answers(), self.reference()))

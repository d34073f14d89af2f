"""A template-matching sweep: one caller scores fresh orientations of one
template against one resident tomogram, ``orientations_per_call`` a
``TemplateMatcher.match`` call, back to back with no synchronise between
calls, as pytom-match-pick walks its angle list.

Traffic keys: ``orientations_per_call``; ``warmup_s`` of calls; a pool of
orientations, uniform over SO(3), that no window can use up
(``pool_floor_ms``, below the least time of an orientation; a window that
does use it up ends there); ``replay.calls``, the calls of the traced
pass, which runs with the program's tracer on.

The config gives the tomogram (``shape``, ``phantom``, ``copies`` of the
template pasted at seeded positions and orientations, ``noise``), the
template (``template_box``, ``template``), the mask and the wedge.

The answers checked are the score and index maps after the window's
first call, against the float64 reference of that call's orientations.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict

import numpy as np
import torch

from voltools_tpu_torch.models.matching import TemplateMatcher
from voltools_tpu_torch.utils import trace as program_trace
from portbench import traffic
from portbench.drivers import _replay
from portbench.reference import matching as reference
from portbench.reference import rel_err, resample
from portbench.roofline import matching as roofline

SPANS = {"match.template": "rotate_ms", "match.correlate": "correlate_ms",
         "match.update": "update_ms"}


def uniform_rotations(rng: np.random.Generator, n: int, centre):
    """``n`` rotations uniform over SO(3) (normalised Gaussian
    quaternions) as (n, 4, 4) float32 pull-back matrices about
    ``centre``."""
    q = rng.normal(size=(4, n))
    w, x, y, z = q / np.linalg.norm(q, axis=0)
    r = np.empty((n, 3, 3))
    r[:, 0] = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (x * z + w * y)], axis=1)
    r[:, 1] = np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x)], axis=1)
    r[:, 2] = np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y)], axis=1)
    c = np.asarray(centre, np.float64)
    m = np.zeros((n, 4, 4))
    m[:, :3, :3] = r
    m[:, :3, 3] = c - r @ c
    m[:, 3, 3] = 1.0
    return m.astype(np.float32)


def spherical_mask(box: int, radius: float, edge_sigma: float, device):
    """A sphere of ``radius`` about voxel ``box // 2`` with a Gaussian edge
    of ``edge_sigma``, float32."""
    g = (torch.arange(box, dtype=torch.float32, device=device) - box // 2)
    r = (g.view(-1, 1, 1) ** 2 + g.view(1, -1, 1) ** 2
         + g.view(1, 1, -1) ** 2).sqrt()
    return torch.where(r <= radius, torch.ones_like(r),
                       torch.exp(-0.5 * ((r - radius) / edge_sigma) ** 2))


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config
        self.tr = cell.traffic
        self.shape = tuple(int(s) for s in self.cfg["shape"])
        self.box = int(self.cfg["template_box"])
        self.per = int(self.tr["orientations_per_call"])

    def _rotations(self, rng, n):
        return uniform_rotations(rng, n, (self.box // 2,) * 3)

    def _tomogram(self, rng, gen):
        """The phantom, the template's copies pasted in, the noise."""
        cfg, device, box = self.cfg, self.cell.device, self.box
        ph = cfg["phantom"]
        tomo = traffic.blob_phantom(self.shape, ph["blobs"], ph["sigma"],
                                    ph["region"], gen, device)
        coef = resample.prefilter(self.template)
        c = box // 2
        for m in self._rotations(rng, cfg["copies"]):
            copy = resample.transform(self.template, m, cfg["interpolation"],
                                      cfg["cval"], coefficients=coef)
            p = [int(rng.integers(c, n - box + c + 1)) for n in self.shape]
            tomo[p[0] - c:p[0] - c + box, p[1] - c:p[1] - c + box,
                 p[2] - c:p[2] - c + box] += copy.float()
        sigma = cfg["noise"] * float(tomo.mean())
        tomo += sigma * torch.randn(self.shape, generator=gen,
                                    device=device)
        return tomo

    def setup(self):
        cell, cfg, tr = self.cell, self.cfg, self.tr
        rng, device_gen = traffic.seeded(cell.seed)
        gen = device_gen(cell.device)
        t = cfg["template"]
        self.template = traffic.blob_phantom(
            (self.box,) * 3, t["blobs"], t["sigma"], t["region"], gen,
            cell.device)
        self.mask = spherical_mask(self.box, cfg["mask"]["radius"],
                                   cfg["mask"]["edge_sigma"], cell.device)
        self.tomogram = self._tomogram(rng, gen)
        self.matcher = TemplateMatcher(
            self.tomogram, self.template, self.mask,
            tilt_range=tuple(cfg["tilt_range_deg"]),
            tilt_axis=cfg["tilt_axis"],
            projection_axis=cfg["projection_axis"],
            interpolation=cfg["interpolation"], device=str(cell.device))
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
                self.kept = matcher.result(output="device")
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
        """The program's own spans over a pass of ``replay.calls`` calls
        with its tracer on (device work included on a CUDA device): the
        device ms an orientation under ``match.template``,
        ``match.correlate`` and ``match.update``, the counters
        ``match.orientations`` and ``match.transforms``, and the device's
        busy time against the pass's wall, its idle by the span the host
        was in."""
        cell, matcher = self.cell, self.matcher
        matcher.reset()
        cell.sync()
        before = program_trace.counts()
        program_trace.start(device=cell.cuda)
        try:
            for chunk in self.replay:
                matcher.match(chunk)
            cell.sync()
        finally:
            program_trace.stop()
        export = program_trace.export()
        after = program_trace.counts()
        counts = {k: after.get(k, 0) - before.get(k, 0)
                  for k in ("match.orientations", "match.transforms")}
        idle = program_trace.idle_gaps(export)
        n = counts["match.orientations"]
        spent = _device_ms_by_span(export, set(SPANS) | {"match"})
        per = {SPANS[k]: spent[k] / n for k in SPANS if k in spent and n}
        if "match" in spent and n:
            per["device_ms"] = spent["match"] / n
            per["least_ms"] = roofline.orientation_ms(self.shape)[0]
        labels = {"match.template": "match.template: kernel A at the box, "
                  "the wedge, the normalisation, the placing",
                  "match.correlate": "match.correlate: rfftn, the product, "
                  "irfftn at the tomogram",
                  "match.update": "match.update: the score and the best "
                  "and index maps"}
        device_ops = sorted(([labels[k], spent[k] / 1e3] for k in SPANS
                             if k in spent), key=lambda p: -p[1])
        gaps = sorted(([f"host in {k}", s] for k, s in
                       idle["idle_s"].items()), key=lambda p: -p[1])
        # off a CUDA device the pass records no device work: no busy time
        record["trace"] = {
            "orientations": n, "counts": counts, "match_ms": per,
            "wall_s": idle["wall_s"] if cell.cuda else None,
            "busy_s": idle["busy_s"] if cell.cuda else None,
            "breakdown": {"device_ops": device_ops[:10],
                          "idle_gaps": gaps[:10]}}

    def release(self):
        """Free the program's state; the data and the snapshot stay for
        the check."""
        del self.matcher, self.pool, self.replay
        if self.cell.cuda:
            torch.cuda.empty_cache()

    def _reference(self, dtype=torch.float64):
        cfg = self.cfg
        return reference.match(
            self.tomogram, self.template, self.mask, self.checked,
            tilt_range=tuple(cfg["tilt_range_deg"]),
            tilt_axis=cfg["tilt_axis"],
            projection_axis=cfg["projection_axis"],
            interpolation=cfg["interpolation"], cval=cfg["cval"],
            dtype=dtype)

    def reference(self, dtype=torch.float64):
        """The reference's best scores over the first call's orientations,
        in ``dtype``."""
        yield self._reference(dtype)[0]

    def answers(self):
        return [self.kept[0]]

    def check(self):
        """``max_rel_err`` of the snapshot's scores, and ``index_mismatch``:
        the share of the voxels whose best and second-best reference
        scores differ by more than 10 times the score limit where the
        snapshot's index is not the reference's."""
        limits = self.cell.limits
        best, index, second = self._reference()
        scores, indices = self.kept
        err = rel_err(scores, best)
        clear = (best - second) > 10 * limits["max_rel_err"]
        wrong = (indices.to(torch.int64) != index) & clear
        mismatch = float(wrong.sum()) / max(1, int(clear.sum()))
        failed = not (err <= limits["max_rel_err"]
                      and mismatch <= limits["index_mismatch"])
        return {"compared": {"max_rel_err": err, "index_mismatch": mismatch},
                "failed": int(failed), "answers": 1}


def _device_ms_by_span(export, names):
    """Device ms of the export's intervals under each of ``names``: an
    interval counts under every one of them among its span and that
    span's ancestors."""
    parent, name = {}, {}
    for e in export["traceEvents"]:
        if e.get("ph") == "X" and e["pid"] == program_trace.HOST:
            parent[e["args"]["id"]] = e["args"]["parent"]
            name[e["args"]["id"]] = e["name"]
    spent = defaultdict(float)
    for e in export["traceEvents"]:
        if e.get("ph") != "X" or e["pid"] != program_trace.DEVICE:
            continue
        span = e["args"]["span"]
        while span is not None:
            if name.get(span) in names:
                spent[name[span]] += e["dur"] / 1e3
            span = parent.get(span)
    return dict(spent)

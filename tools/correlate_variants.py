#!/usr/bin/env python3
"""Where template matching's correlation spends its device time, on one
GPU, at ``tm512``'s shapes: a (256, 512, 512) tomogram, a 48^3 template.

Two parts:

* ``score``: ``TemplateMatcher.match`` of 16 orientations under
  ``torch.profiler`` (CUDA activity), its kernels by name, in us an
  orientation.  The matcher is imported from ``root`` (the first
  argument after ``score``; default: this repository), so another
  commit's tree can be profiled in the same call.
* ``variants``: the span ``match.correlate``'s work written out in
  variants, from one placed random template and one random spectrum:

  - ``whole_out``: ``rfftn(padded, out=)``, ``mul_``, ``irfftn(out=)``
    over a tomogram-sized placed volume;
  - ``whole``: the same without ``out=``;
  - ``xzy``: the forward axis by axis on the template's lines only,
    ``rfft`` along x on its 48 x 48 rows, ``fft`` along z on its 48
    y-rows, one ``fft`` along y over the whole grid, then ``mul_`` and
    ``irfftn``; the copies into the windows by ``index_copy_``;
  - ``xzy_slices``: as ``xzy``, each window's copy as two slices;
  - ``xyz``: as ``xzy`` with the y pass on the template's 48 planes and
    the whole-grid pass along z.

  Each variant's spectrum is checked against ``rfftn`` of the placed
  volume, and its correlation against ``whole_out``'s; each is profiled
  (kernels by name, us an orientation) and timed with CUDA events
  (forward, product and inverse apart, and the three together), in turns:
  the list, then the list reversed, ``TURNS`` times.

Run from the repository root::

    python3 tools/correlate_variants.py variants
    python3 tools/correlate_variants.py score [root]

Each prints one JSON line, the card's name and power limit in it, and
writes it to ``chiprun_out/correlate_variants_<part>.json`` (``score``:
``correlate_variants_score_<root's name>.json``).
"""

import json
import os
import statistics
import subprocess
import sys
from collections import defaultdict

SHAPE = (256, 512, 512)
BOX = 48
ORIENTATIONS = 16
REPS = 20
TURNS = 3


def profiled(torch, fn, n):
    """{kernel name: device us a call of ``fn``} over ``n`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us[e.name[:96]] += e.time_range.elapsed_us() / n
    return dict(sorted(us.items(), key=lambda kv: -kv[1]))


def event_ms(torch, fn, reps=REPS):
    """Device ms a call of ``fn``: CUDA events around ``reps`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def copy_window(dst, dim, src, c):
    """``src``'s lines along ``dim`` into ``dst``'s window, two slices."""
    b, n = src.shape[dim], dst.shape[dim]
    dst.narrow(dim, 0, c + 1).copy_(src.narrow(dim, 0, c + 1))
    if b > c + 1:
        dst.narrow(dim, n - (b - c - 1), b - c - 1).copy_(
            src.narrow(dim, c + 1, b - c - 1))


def variants(torch, dev="cuda"):
    from voltools_tpu_torch.models.matching import _placed, _window
    dev = torch.device(dev)
    Z, Y, X = SHAPE
    xh = X // 2 + 1
    c = BOX // 2
    gen = torch.Generator(device=dev).manual_seed(20251018)
    t = torch.randn((BOX,) * 3, device=dev, generator=gen)
    spectrum = torch.randn((Z, Y, xh), dtype=torch.complex64, device=dev,
                           generator=gen)
    padded = torch.zeros(SHAPE, device=dev)
    padded.view(-1).index_copy_(
        0, _placed(t, SHAPE, (c,) * 3, reflect=True), t.view(-1))
    want = torch.fft.rfftn(padded)
    rows = torch.zeros((BOX, BOX, X), device=dev)
    rows.view(-1).index_copy_(
        0, _placed(t, (BOX, BOX, X), (c,) * 3, reflect=True), t.view(-1))
    zpos = _window(BOX, c, Z, dev)
    ypos = _window(BOX, c, Y, dev)
    ft_out = torch.empty_like(want)
    cc_out = torch.empty(SHAPE, device=dev)
    # xzy: z pass on the template's y-rows, the whole-grid pass along y,
    # over a grid whose y axis is outermost so its batch collapses
    cols = torch.zeros((Z, BOX, xh), dtype=torch.complex64, device=dev)
    planes = torch.zeros((Y, Z, xh), dtype=torch.complex64,
                         device=dev).permute(1, 0, 2)
    # xyz: y pass on the template's planes, y innermost in its buffer
    ybuf = torch.zeros((BOX, xh, Y), dtype=torch.complex64,
                       device=dev).permute(0, 2, 1)
    zbuf = torch.zeros((Z, Y, xh), dtype=torch.complex64, device=dev)

    def fwd_whole_out():
        torch.fft.rfftn(padded, out=ft_out)
        return ft_out

    def fwd_whole():
        return torch.fft.rfftn(padded)

    def fwd_xzy():
        cols.index_copy_(0, zpos, torch.fft.rfft(rows, dim=2))
        planes.index_copy_(1, ypos, torch.fft.fft(cols, dim=0))
        return torch.fft.fft(planes, dim=1)

    def fwd_xzy_slices():
        copy_window(cols, 0, torch.fft.rfft(rows, dim=2), c)
        copy_window(planes, 1, torch.fft.fft(cols, dim=0), c)
        return torch.fft.fft(planes, dim=1)

    def fwd_xyz():
        ybuf.index_copy_(1, ypos, torch.fft.rfft(rows, dim=2))
        zbuf.index_copy_(0, zpos, torch.fft.fft(ybuf, dim=1))
        return torch.fft.fft(zbuf, dim=0)

    def inv_out(ft):
        torch.fft.irfftn(ft, s=SHAPE, norm="forward", out=cc_out)
        return cc_out

    def inv(ft):
        return torch.fft.irfftn(ft, s=SHAPE, norm="forward")

    table = {"whole_out": (fwd_whole_out, inv_out), "whole": (fwd_whole, inv),
             "xzy": (fwd_xzy, inv), "xzy_slices": (fwd_xzy_slices, inv),
             "xyz": (fwd_xyz, inv)}
    out = {}
    ref_cc = None
    for name, (fwd, inverse) in table.items():
        ft = fwd()
        err = float((ft - want).abs().max() / want.abs().max())
        s = torch.empty_like(ft).copy_(spectrum)
        prod = ft.clone().mul_(s)
        cc = inverse(prod).clone()
        if ref_cc is None:
            ref_cc = cc
        cc_err = float((cc - ref_cc).abs().max() / ref_cc.abs().max())
        held = prod.clone()

        def whole(fwd=fwd, inverse=inverse, s=s):
            return inverse(fwd().mul_(s))

        def product(s=s, held=held):
            return held.mul_(s)

        def inverse_only(inverse=inverse, prod=prod):
            return inverse(prod)

        out[name] = {
            "spectrum_rel_err": err, "cc_rel_err": cc_err,
            "ft_stride": list(ft.stride()), "cc_stride": list(cc.stride()),
            "cc_contiguous": cc.is_contiguous(),
            "kernels_us": profiled(torch, whole, 10),
            "parts": (fwd, product, inverse_only, whole)}
    # in turns: the list, then the list reversed
    names = list(table)
    times = defaultdict(list)
    for turn in range(TURNS):
        for name in (names if turn % 2 == 0 else names[::-1]):
            parts = out[name]["parts"]
            for part, fn in zip(("forward", "product", "inverse", "all"),
                                parts):
                times[(name, part)].append(event_ms(torch, fn))
    for name in names:
        del out[name]["parts"]
        out[name]["ms"] = {p: statistics.median(times[(name, p)])
                           for p in ("forward", "product", "inverse", "all")}
        out[name]["ms_all_turns"] = times[(name, "all")]
    return out


def score(torch, root):
    sys.path.insert(0, root)
    from voltools_tpu_torch import TemplateMatcher
    from portbench.drivers.template_match import (spherical_mask,
                                                  uniform_rotations)
    import numpy as np
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    tomogram = torch.randn(SHAPE, device=dev, generator=gen)
    template = torch.randn((BOX,) * 3, device=dev, generator=gen)
    mask = spherical_mask(BOX, 20.0, 2.0, dev)
    tm = TemplateMatcher(tomogram, template, mask, device="cuda")
    del tomogram
    rng = np.random.default_rng(11)
    ms = uniform_rotations(rng, ORIENTATIONS, (BOX // 2,) * 3)
    tm.match(ms)
    kernels = profiled(torch, lambda: tm.match(ms), 3)
    per = {k: v / ORIENTATIONS for k, v in kernels.items()}
    ms_call = event_ms(torch, lambda: tm.match(ms), 10)
    return {"root": root, "kernels_us": per,
            "device_us": sum(per.values()),
            "event_ms_an_orientation": ms_call / ORIENTATIONS,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    part = sys.argv[1] if len(sys.argv) > 1 else "variants"
    root = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else here
    if part not in ("variants", "score"):
        print(f"correlate_variants: no part {part!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("correlate_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("card:", card.strip())
    result = {"card": card.strip(), "torch": torch.__version__}
    if part == "score":
        result["score"] = score(torch, root)
    else:
        sys.path.insert(0, here)
        result["variants"] = variants(torch)
    print(json.dumps(result))
    tag = part if part == "variants" else f"score_{os.path.basename(root)}"
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out",
                           f"correlate_variants_{tag}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

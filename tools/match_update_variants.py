#!/usr/bin/env python3
"""What the layout of template matching's update kernel buys, on one GPU.

Builds variants of ``voltools_tpu_torch/csrc/match_update.cu`` from edited
copies of the source (in a temporary directory; the repository is not
touched): a CTA of ``threads`` threads, each issuing the loads of
``groups`` float4 groups before any arithmetic (``LAYOUTS``; the committed
kernel is 256 x 4).  It checks that each gives the committed kernel's
scores (their bit patterns), indices and improved-voxel count from the
same start, and the committed kernel the plain version's
(``plain_match_update``), and times each launch with CUDA events, the maps
restored outside the events before it, in turns (the list, then the list
reversed), at the tomogram's (256, 512, 512), from four starts:

* ``none_written``  -- every best above its score: the three maps read,
  nothing written (what a long sweep tends to);
* ``all_written``   -- the maps ``reset()`` leaves: every score and index
  written;
* ``pct1_written``, ``pct10_written`` -- 1% or 10% of the voxels, drawn at
  random, improve: the writes scatter over 32-byte sectors.

Beside them: the plain version (the four torch kernels), a copy of one
268 MB map, and the bounds (cc, inv and the scores read once, 12 bytes a
voxel; with a score and an index written at every voxel, 20 bytes).
Run from the repository root:

    python3 tools/match_update_variants.py

It prints the card's name and power limit, one JSON line per layout with
nvcc's ``-Xptxas -v`` lines (registers, spills), then one JSON line of the
median ms of 10 launches of each layout from each start, one median a
turn.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

SHAPE = (256, 512, 512)
# (threads a CTA, float4 groups a thread); the first is the committed one
LAYOUTS = [(256, 4), (256, 1), (256, 2), (256, 8), (128, 4), (512, 2),
           (512, 4)]
COMMITTED = "constexpr int kThreads = 256;", "constexpr int kGroups = 4;"
STARTS = ("none_written", "all_written", "pct1_written", "pct10_written")
REPS = 10
HBM_BYTES_PER_S = 3.35e12    # H100 SXM's HBM3


def edits(threads, groups):
    """The (old, new) edits of the source that give the layout."""
    return [(COMMITTED[0], f"constexpr int kThreads = {threads};"),
            (COMMITTED[1], f"constexpr int kGroups = {groups};")]


def edited(source, threads, groups):
    """The source with the layout's edits made, each exactly once."""
    for old, new in edits(threads, groups):
        assert source.count(old) == 1, old
        source = source.replace(old, new)
    return source


def name(layout):
    return "x".join(map(str, layout))


def main():
    # the package lives at the repository root, one level up
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    if not torch.cuda.is_available():
        print("match_update_variants: no CUDA device", file=sys.stderr)
        return 1
    from voltools_tpu_torch.kernels import _build
    from voltools_tpu_torch.kernels.match_update import (ARGTYPES,
                                                         plain_match_update)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    source = open(_build.CSRC_DIR / "match_update.cu").read()
    tmp = tempfile.mkdtemp()
    try:
        def build(layout):
            path = os.path.join(tmp, f"match_update_{name(layout)}.cu")
            with open(path, "w") as f:
                f.write(edited(source, *layout))
            lib = os.path.join(tmp, f"libmatch_update_{name(layout)}.so")
            proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                                   "-o", lib, path], capture_output=True,
                                  text=True, timeout=600)
            assert proc.returncode == 0, (layout, proc.stdout, proc.stderr)
            return lib, [ln.strip() for ln in (proc.stdout + proc.stderr)
                         .splitlines() if "registers" in ln or "spill" in ln]

        with ThreadPoolExecutor(len(LAYOUTS)) as pool:
            built = dict(zip(LAYOUTS, pool.map(build, LAYOUTS)))
        fns = {}
        for layout, (path, ptxas) in built.items():
            fn = ctypes.CDLL(path).match_update_launch
            fn.argtypes = ARGTYPES
            fn.restype = ctypes.c_int
            fns[layout] = fn
            print(json.dumps({"layout": name(layout), "ptxas": ptxas}),
                  flush=True)

        dev = torch.device("cuda", 0)
        n = SHAPE[0] * SHAPE[1] * SHAPE[2]
        gen = torch.Generator(device=dev).manual_seed(21)
        cc = torch.randn(SHAPE, generator=gen, device=dev)
        inv = torch.rand(SHAPE, generator=gen, device=dev).add_(0.5)
        s = cc * inv
        starts = {"none_written": s + 1.0,
                  "all_written": torch.full(SHAPE, -float("inf"),
                                            device=dev)}
        for share, start in ((0.01, "pct1_written"),
                             (0.10, "pct10_written")):
            improve = torch.rand(SHAPE, generator=gen, device=dev) < share
            starts[start] = torch.where(improve, s - 1.0, s + 1.0)
        del s
        first_indices = torch.zeros(SHAPE, dtype=torch.int32, device=dev)
        scores = torch.empty(SHAPE, device=dev)
        indices = torch.empty_like(first_indices)
        counter = torch.zeros(1, dtype=torch.int64, device=dev)

        def restore(start):
            scores.copy_(starts[start])
            indices.copy_(first_indices)

        def launch(layout):
            code = fns[layout](cc.data_ptr(), inv.data_ptr(),
                               scores.data_ptr(), indices.data_ptr(), n, 7,
                               counter.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
            assert code == 0, (layout, code)

        # every layout gives the committed kernel's maps and count, and
        # that the plain version's, bit for bit
        for start in STARTS:
            want = (starts[start].clone(), first_indices.clone())
            plain_match_update(cc, inv, *want, 7)
            counts = {}
            for layout in LAYOUTS:
                restore(start)
                counter.zero_()
                launch(layout)
                torch.cuda.synchronize()
                assert torch.equal(scores.view(torch.int32),
                                   want[0].view(torch.int32)), (start, layout)
                assert torch.equal(indices, want[1]), (start, layout)
                counts[layout] = int(counter.item())
            changed = int((want[1] != first_indices).sum())
            assert set(counts.values()) == {changed}, (start, counts, changed)
            del want

        def median_ms(layout, start):
            runs = []
            for _ in range(REPS):
                restore(start)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                launch(layout)
                b.record()
                torch.cuda.synchronize()
                runs.append(a.elapsed_time(b))
            return sorted(runs)[REPS // 2]

        for layout in LAYOUTS:                   # warm the clocks
            for start in STARTS:
                median_ms(layout, start)
        times = {start: {name(layout): [] for layout in LAYOUTS}
                 for start in STARTS}
        for turn in (LAYOUTS, LAYOUTS[::-1]):
            for layout in turn:
                for start in STARTS:
                    times[start][name(layout)].append(median_ms(layout,
                                                                start))

        def event_ms(fn):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b)

        restore("all_written")
        plain = sorted(event_ms(lambda: plain_match_update(
            cc, inv, scores, indices, 7)) for _ in range(REPS))[REPS // 2]
        copy = sorted(event_ms(lambda: scores.copy_(cc))
                      for _ in range(REPS))[REPS // 2]
        print(json.dumps({
            "shape": list(SHAPE), "median_ms": times, "plain_ms": plain,
            "copy_268MB_ms": copy,
            "bound_ms": 12.0 * n / HBM_BYTES_PER_S * 1e3,
            "bound_all_written_ms": 20.0 * n / HBM_BYTES_PER_S * 1e3,
            "equal_to_committed_and_plain": True}), flush=True)
    finally:
        shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())

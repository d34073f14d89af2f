#!/usr/bin/env python3
"""What each part of the walk kernel's design buys, on one GPU.

Builds variants of ``voltools_tpu_torch/csrc/affine_resample.cu`` from
edited copies of the source (in a temporary directory; the repository is
not touched), checks that each gives the committed kernel's output bit for
bit, and times each on the same 250^3 matrices, with CUDA events, in one
process:

* ``as_is``           -- the kernel as committed: (2, 8, 8) bricks of 4
  warps, each launch taking the warp patch that ``planner.walk_patch``
  picks, (1, 4, 8) or (2, 2, 8); per spline order (``Tile``) the voxels a
  thread computes, a register cap and the interior fast path;
* ``flat_1x4x8``, ``deep_2x2x8`` -- one of the two patches for every
  launch;
* ``line_warps``      -- a warp holds 32 voxels along x, 4 warps a CTA,
  one voxel a thread (128 threads along x, the mapping before the warp
  patches);
* ``cta_256``         -- (2, 8, 16) bricks of 8 warps;
* ``linear_*``, ``cubic_*`` -- one order's ``Tile`` changed: ``voxels_n``
  voxels a thread, ``regs_uncapped`` without the register cap;
* ``edge_path_only``  -- no interior fast path (cubic's warps all take the
  edge path, as trilinear's do);
* ``offsets_64``      -- the fast path's row offsets in 64 bits;
* ``scalar_rows``     -- cubic's fast path reads a row one float at a
  time; ``float4_rows`` -- always as aligned float4 loads;
  ``rows_from_8``, ``rows_from_16`` -- float4 loads where a warp's first
  taps lie in at least that many rows (the committed kernel's threshold
  is ``kVectorRowsFrom``, 12);
* ``no_count``        -- no fast-path counter (what the device count
  costs);
* ``all_off``         -- line warps, one voxel a thread, no fast path,
  64-bit offsets, scalar rows (it keeps the new matrix loads and
  multiply-shift block indices);
* ``baseline``        -- ``tools/walk_baseline.cu``, the kernel before the
  redesign.

Matrix sets: the 41-tilt series about axes 1 (the projector's) and 0 (the
reconstruction's), 'rzxz' about the centre, and bench.py's 16 random
'sxyz' rotations; trilinear and cubic, 'constant', on the pitched resident
volume; one matrix a launch (``single``) and the set's first 16 in one
launch (``batch``).  It also prints, per set and warp patch, the share of
cubic's in-range voxels that took the interior fast path, as the kernel
counted them on the device, and the committed kernel on the same voxels
contiguous (250-float rows: scalar rows).
Run from the repository root:

    python3 tools/walk_variants.py

It prints the card's name and power limit, then one JSON line per matrix
set and order: ms per 250^3 matrix for each variant.  With ``--model`` it
needs no card and prints, per set, order and patch, a model of L1's work:
the mean number of distinct 128-byte lines that a warp's tap loads
touch (``lines_per_warp``).
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor


def brick(bz, by, bx):
    """The edits that give a CTA a (bz, by, bx) brick."""
    return [("constexpr int kBrickZ = 2;", f"constexpr int kBrickZ = {bz};"),
            ("constexpr int kBrickY = 8;", f"constexpr int kBrickY = {by};"),
            ("constexpr int kBrickX = 8;", f"constexpr int kBrickX = {bx};")]


def only(pz, py, px):
    """The edits that make both warp patches (pz, py, px)."""
    return [("constexpr int kFlatZ = 1, kFlatY = 4, kFlatX = 8;",
             f"constexpr int kFlatZ = {pz}, kFlatY = {py}, kFlatX = {px};"),
            ("constexpr int kDeepZ = 2, kDeepY = 2, kDeepX = 8;",
             f"constexpr int kDeepZ = {pz}, kDeepY = {py}, kDeepX = {px};")]


def rows_from(n):
    """Cubic float4 rows where a warp's first taps lie in >= n rows."""
    return [("constexpr int kVectorRowsFrom = 12;",
             f"constexpr int kVectorRowsFrom = {n};")]


def tile(order, **values):
    """The edits of Tile<ORDER>'s values for spline ``order`` (1 or 3):
    kVoxels, kMinBlocks."""
    def edit(text):
        for name, value in values.items():
            pattern = (rf"(static constexpr \w+ {name} = ORDER == 1 \? )"
                       rf"(\w+)( : )(\w+)(;)")
            value = str(value).lower()

            def put(m):
                first, second = ((value, m.group(4)) if order == 1
                                 else (m.group(2), value))
                return m.group(1) + first + m.group(3) + second + m.group(5)
            text, count = re.subn(pattern, put, text)
            assert count == 1, name
        return text
    return [edit]


LINE_WARPS = (brick(1, 1, 128) + only(1, 1, 32) + tile(1, kVoxels=1)
              + tile(3, kVoxels=1, kMinBlocks=1))
EDGE_ONLY = [("ORDER == 3 && __all_sync(kWarpMask, interior || !inside);",
              "false;")]
OFFSETS_64 = [("const bool offsets32 = static_cast<long long>(d0) * d1 * "
               "pitch <= INT_MAX;", "const bool offsets32 = false;")]

# name: (edits of the source -- (old, new) pairs or functions of the text
# -- and the warp patch of every launch: "planner" for walk_patch's choice,
# "flat" or "deep"); "baseline" is tools/walk_baseline.cu
VARIANTS = {
    "as_is": ([], "planner"),
    "flat_1x4x8": ([], "flat"),
    "deep_2x2x8": ([], "deep"),
    "line_warps": (LINE_WARPS, "flat"),
    "cta_256": (brick(2, 8, 16), "planner"),
    "linear_voxels_1": (tile(1, kVoxels=1), "planner"),
    "linear_voxels_3": (tile(1, kVoxels=3), "planner"),
    "cubic_voxels_1": (tile(3, kVoxels=1), "planner"),
    "cubic_voxels_3": (tile(3, kVoxels=3), "planner"),
    "cubic_regs_uncapped": (tile(3, kMinBlocks=1), "planner"),
    "edge_path_only": (EDGE_ONLY, "planner"),
    "offsets_64": (OFFSETS_64, "planner"),
    "scalar_rows": (rows_from(33), "planner"),
    "float4_rows": (rows_from(0), "planner"),
    "rows_from_8": (rows_from(8), "planner"),
    "rows_from_16": (rows_from(16), "planner"),
    "no_count": ([("    fast_voxels = __reduce_add_sync(kWarpMask, "
                   "fast_voxels);\n    if (lane == 0 && fast_voxels) {",
                   "    if (false) {")], "planner"),
    "all_off": (LINE_WARPS + EDGE_ONLY + OFFSETS_64 + rows_from(33), "flat"),
    "baseline": ([], None),
}
BATCH = 16


def lines_per_warp(np, ms, patch_zyx, order, vec, warps=200, seed=1):
    """A model of L1's work, not a measurement: the mean number of distinct
    128-byte lines that a warp's tap loads touch, summed over its loads
    (L1 serves a load one line at a time), for warps whose
    (pz, py, px) patch lies at random places of a 250^3 pitched volume
    (rows 252 floats apart), with vec the float4 row loads of the kernel
    (a load counted where any lane issues it)."""
    rng = np.random.default_rng(seed)
    lane = np.stack([g.ravel() for g in np.meshgrid(
        *[np.arange(p) for p in patch_zyx], indexing="ij")], 1)
    taps, first = (2, 0) if order == 1 else (4, -1)
    lines = 0
    for m in ms:
        for _ in range(warps):
            corner = rng.integers(40, 200, 3) // patch_zyx * patch_zyx
            src = (m[:3, :3] @ (corner + lane).T + m[:3, 3:]).T
            base = np.floor(src).astype(np.int64) + first
            groups = []
            for iz in range(taps):
                for iy in range(taps):
                    row = ((base[:, 0] + iz) * 250 + base[:, 1] + iy) * 252
                    if not vec:
                        groups += [row + base[:, 2] + ix
                                   for ix in range(taps)]
                        continue
                    x0 = base[:, 2] & ~3
                    r = base[:, 2] & 3
                    groups.append(row + x0)
                    more = r != 0 if order == 3 else r == 3
                    if more.any():
                        groups.append((row + x0 + 4)[more])
            lines += sum(len(np.unique(g * 4 // 128)) for g in groups)
    return lines / (warps * len(ms))


def model(np, sets):
    """Print the line model of every set, order and patch."""
    for set_name, ms in sets.items():
        ms = ms.astype(np.float64)[::max(1, len(ms) // 8)]
        for order in (1, 3):
            print(json.dumps({"set": set_name, "order": order,
                              "model_lines_per_warp": {
                                  "x".join(map(str, p)) + (
                                      "_float4" if vec else ""):
                                  lines_per_warp(np, ms, np.array(p), order,
                                                 vec)
                                  for p in ((1, 1, 32), (1, 4, 8),
                                            (1, 2, 16), (2, 2, 8))
                                  for vec in (False, True)}}), flush=True)


def matrix_sets(np, transform_matrix, shape):
    """The 41-tilt series about axes 1 and 0 and bench.py's 16 random
    rotations (after its 250^3 volume, from default_rng(0)), float32."""
    rng = np.random.default_rng(0)
    vol = rng.random(shape, dtype=np.float64).astype(np.float32)
    rots = np.stack([transform_matrix(
        rotation=tuple(rng.uniform(-180, 180, 3)), rotation_order="sxyz",
        center=(125.0,) * 3) for _ in range(16)]).astype(np.float32)
    center = np.divide(np.subtract(shape, 1), 2, dtype=np.float32)

    def tilts(axis):
        ms = []
        for a in np.arange(-60.0, 61.0, 3.0):
            triple = [0.0, 0.0, 0.0]
            triple[axis] = float(a)
            ms.append(transform_matrix(rotation=triple,
                                       rotation_order="rzxz",
                                       center=center))
        return np.stack(ms).astype(np.float32)

    return vol, {"tilt_axis_1": tilts(1), "tilt_axis_0": tilts(0),
                 "random": rots}


def main():
    # the package lives at the repository root, one level up
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    from voltools_tpu_torch.utils import transform_matrix
    if sys.argv[1:] == ["--model"]:
        model(np, matrix_sets(np, transform_matrix, (250,) * 3)[1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("walk_variants: no CUDA device", file=sys.stderr)
        return 1
    from voltools_tpu_torch.kernels import _build
    from voltools_tpu_torch.kernels.affine_resample import (
        ARGTYPES, DEEP_PATCH, FLAT_PATCH, vector_rows)
    from voltools_tpu_torch.kernels.planner import walk_patch
    from voltools_tpu_torch.kernels.layout import pitched
    from voltools_tpu_torch.ops.sampling import affine_coords, affine_sample

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    source = open(_build.CSRC_DIR / "affine_resample.cu").read()
    baseline = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "walk_baseline.cu")).read()
    tmp = tempfile.mkdtemp()
    try:
        shutil.copy(_build.CSRC_DIR / "resample_taps.cuh", tmp)

        def build(name):
            text = baseline if name == "baseline" else source
            for edit in VARIANTS[name][0]:
                if callable(edit):
                    text = edit(text)
                    continue
                old, new = edit
                assert old in text, (name, old)
                text = text.replace(old, new)
            path = os.path.join(tmp, f"{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            lib = os.path.join(tmp, f"lib{name}.so")
            proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                                   "-o", lib, path], capture_output=True,
                                  text=True, timeout=600)
            assert proc.returncode == 0, (name, proc.stdout, proc.stderr)
            return lib, [ln.strip() for ln in (proc.stdout + proc.stderr)
                         .splitlines() if "registers" in ln or "spill" in ln]

        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
        libs = {}
        for name, (path, ptxas) in built.items():
            fn = ctypes.CDLL(path).affine_resample_launch
            # the baseline takes neither float4 rows, a patch nor counters
            fn.argtypes = (ARGTYPES[:13] + [ARGTYPES[15], ARGTYPES[17]]
                           if name == "baseline" else ARGTYPES)
            fn.restype = ctypes.c_int
            libs[name] = fn
            print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)

        dev = torch.device("cuda", 0)
        shape = (250,) * 3
        vol_np, sets = matrix_sets(np, transform_matrix, shape)
        flat = torch.from_numpy(vol_np).to(dev)
        vol = pitched(flat)
        assert vector_rows(vol) and not vector_rows(flat)
        out = torch.empty((BATCH,) + shape, device=dev)
        # the kernels' fast-path counter: slots of 16 words, the first of
        # each counting in-range voxels that took the fast path
        counts = torch.zeros(
            (ctypes.CDLL(built["as_is"][0]).affine_resample_count_words()
             // 16, 16), dtype=torch.int64, device=dev)

        def launch(name, v, ms_dev, n, order, ms_host):
            rule = VARIANTS[name][1]
            deep = (rule == "deep" or rule == "planner" and
                    walk_patch(ms_host) == DEEP_PATCH)
            args = [v.data_ptr(), *shape, v.stride(1), ms_dev.data_ptr(), n,
                    out.data_ptr(), *shape, order, 0]
            if rule is not None:
                args += [int(vector_rows(v)), int(deep), 0.0,
                         counts.data_ptr()]
            else:
                args.append(0.0)
            code = libs[name](*args, torch.cuda.current_stream().cuda_stream)
            assert code == 0, (name, code)

        def fast_share(name, ms_dev, order, ms):
            """The share of the in-range voxels of ``name``'s launches, one
            matrix each, that took the fast path, by the kernel's count
            and the plain version's coordinates."""
            counts.zero_()
            in_range = 0
            for i in range(len(ms)):
                launch(name, vol, ms_dev[i], 1, order, ms[i])
                s = affine_coords(shape, ms_dev[i])
                inside = torch.ones(shape, dtype=torch.bool, device=dev)
                for a in range(3):
                    inside &= (s[a] >= 0) & (s[a] <= shape[a] - 1)
                in_range += int(inside.sum())
            return int(counts[:, 0].sum()) / in_range

        def time_ms(fn, reps):
            for i in range(3):
                fn(i)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for i in range(reps):
                fn(i)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps

        for set_name, ms in sets.items():
            ms_dev = torch.from_numpy(ms).to(dev)
            for order, interp in ((1, "linear"), (3, "bspline")):
                # every variant gives the committed kernel's output, and
                # that the plain version's, bit for bit
                launch("as_is", vol, ms_dev[5], 1, order, ms[5])
                want = out[0].clone()
                assert torch.equal(want, affine_sample(
                    vol, ms_dev[5], interp, prefiltered=True)), \
                    (set_name, order, "as_is != plain")
                launch("as_is", vol, ms_dev, BATCH, order, ms[:BATCH])
                batch_want = out.clone()
                for name in VARIANTS:
                    launch(name, vol, ms_dev[5], 1, order, ms[5])
                    assert torch.equal(out[0], want), (set_name, order, name)
                    launch(name, vol, ms_dev, BATCH, order, ms[:BATCH])
                    assert torch.equal(out, batch_want), (set_name, order,
                                                          name, "batch")
                launch("as_is", flat, ms_dev[5], 1, order, ms[5])
                assert torch.equal(out[0], want), (set_name, order,
                                                   "contiguous")
                single, batch = {}, {}
                for name in VARIANTS:
                    single[name] = time_ms(
                        lambda i, name=name: launch(
                            name, vol, ms_dev[i % len(ms)], 1, order,
                            ms[i % len(ms)]), 2 * len(ms))
                    batch[name] = time_ms(
                        lambda i, name=name: launch(name, vol, ms_dev, BATCH,
                                                    order, ms[:BATCH]),
                        3) / BATCH
                single["as_is_contiguous"] = time_ms(
                    lambda i: launch("as_is", flat, ms_dev[i % len(ms)], 1,
                                     order, ms[i % len(ms)]), 2 * len(ms))
                line = {"set": set_name, "order": order, "matrices": len(ms),
                        "ms_per_matrix": single, "batch_ms_per_matrix": batch,
                        "deep_patch_matrices": sum(
                            walk_patch(m) == DEEP_PATCH for m in ms),
                        "equal_to_as_is_and_plain": True}
                if order == 3:
                    # cubic's interior fast path, per warp patch, as the
                    # kernels counted it
                    line["fast_path_share"] = {
                        "x".join(map(str, p)): fast_share(name, ms_dev, order,
                                                          ms)
                        for p, name in ((FLAT_PATCH, "flat_1x4x8"),
                                        (DEEP_PATCH, "deep_2x2x8"),
                                        ((1, 1, 32), "line_warps"))}
                print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())

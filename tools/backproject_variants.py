#!/usr/bin/env python3
"""What bounds the back-projection C's row-gather path, and what each part
of its design buys, on one GPU.

Builds variants of ``voltools_tpu_torch/csrc/backproject.cu`` from edited
copies of the source or another layout (the ``-D`` flags of the wrapper's
``LAYOUT``), and ``tools/backproject_baseline.cu`` (the kernel before its
redesign) with one edit, in a temporary directory (the
repository is not touched); checks that each variant that computes the
function gives the committed kernel's output, and that the plain
version's, bit for bit, with no window miss; and times each with CUDA
events, in one process, in turns (the list, then the list reversed):

* ``baseline``      -- ``tools/backproject_baseline.cu``: each warp loads
  its two projection rows a tilt from global memory (L1 and L2);
* ``baseline_row0`` -- the baseline with every line reading rows 0 and 1
  of each tilt, so every load hits L1 and only its arithmetic and load
  instructions are timed (its output is not the function's and is not
  checked);
* ``new``           -- the kernel as committed, with the tile
  ``rowgather_tile`` picks (4 x 8 lines): the tile's window staged in
  shared memory by one TMA copy a tilt, in a ring of 2 stages, a line
  table a tilt, no register reuse;
* ``one_stage``, ``three_stages`` -- a ring of 1 (no copy in flight while
  the CTA sums: an edit that stages each tilt after the barrier that ends
  the last) or 3 windows;
* ``reuse``         -- the last line's rows kept in registers: where r0
  steps by one, one row read a line (an edit of the fast loop);
* ``no_staging``, ``no_staging_reuse`` -- without the TMA copies: the line
  table, the shared-memory reads and the sums alone (their output is not
  the function's and is not checked);
* ``tile_8x8``, ``tile_2x8``, ``tile_1x8``, ``tile_8x1`` -- the committed
  kernel with another tile, its window sized by ``window_rows``;
* ``pairs_2_min3``  -- 2 column pairs a thread (128-column tiles) and 3
  CTAs an SM (at most 85 registers): more warps, fewer sums a thread;
* ``lines_4_min3``  -- 4 lines a thread (a 8 x 4 tile), 3 CTAs an SM.

It also times the wrapper's pitched copy of the projections that TMA
needs where a row is not a multiple of 16 bytes (``pitched_copy_ms``, of
projections one column narrower than the shape's, so never aligned).

Shapes: the reconstruction's series (41 tilts -60..+60 degrees, 'rzxz' at
position 0 about the centre, projection axis 0) back-projected into 250^3
from 41 projections of 250^2, and into a tomogram's (256, 512, 512) from
41 projections of 512^2.  Run from the repository root:

    python3 tools/backproject_variants.py

It prints the card's name and power limit, one JSON line per variant with
nvcc's ``-Xptxas -v`` lines (registers, shared memory, spills), then one
JSON line per shape: ms per back-projection for each variant, each run of
the turns apart, beside the tile, the shared memory a CTA and the bound.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

TILTS = (-60.0, 61.0, 3.0)
SHAPES = ((250, 250, 250), (256, 512, 512))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
FP32_FLOPS = 67e12          # H100 SXM fp32 rate, an FMA counted as 2
FLOPS = 4                   # a lerp and the sum, a voxel a tilt

MIN_3 = ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 3;")
# a ring of one window: every warp is done with it before the next tilt is
# staged into it, and nothing is staged ahead
ONE_STAGE = [
    ('static_assert(kStages >= 2, "a ring of at least two windows");', ""),
    ("    barrier_wait(&full[slot], ",
     "    __syncthreads();\n    stage_ahead(t, slot);\n"
     "    barrier_wait(&full[slot], "),
    ("    stage_ahead(t + kStages - 1, (t + kStages - 1) % kStages);\n", "")]
# the last line's rows kept in registers: where a line's rows are the last
# line's, or one row on, only the new row is read (warp-uniform branches)
REUSE = ("""      for (int k = 0; k < LINES; ++k) {
        const float4 e = lines[k];
        const int off0 = __float_as_int(e.z), off1 = __float_as_int(e.w);
        read_row(g0, s + off0);
        read_row(g1, s + off1);""", """      int held0 = -1, held1 = -1;   // the offsets g0 and g1 hold
      for (int k = 0; k < LINES; ++k) {
        const float4 e = lines[k];
        const int off0 = __float_as_int(e.z), off1 = __float_as_int(e.w);
        if (off0 == held0 && off1 == held1) {
        } else if (off0 == held1) {
          for (int p = 0; p < kPairs; ++p) g0[p] = g1[p];
          read_row(g1, s + off1);
        } else if (off1 == held0) {
          for (int p = 0; p < kPairs; ++p) g1[p] = g0[p];
          read_row(g0, s + off0);
        } else {
          read_row(g0, s + off0);
          read_row(g1, s + off1);
        }
        held0 = off0;
        held1 = off1;""")
NO_STAGING = ("stage_window(staged + first, &map, &full[slot], "
              "any ? box_bytes : 0u,",
              "stage_window(staged + first, &map, &full[slot], 0u,")
ROW0 = ("const int r0 = (v0 || v1) ? static_cast<int>(r0f) : 0;",
        "const int r0 = 0;")
# name: (source: "new" or "baseline", edits (old, new), layout changes,
# forced tile or None, whether its output is the function's)
VARIANTS = {
    "baseline": ("baseline", [], {}, None, True),
    "baseline_row0": ("baseline", [ROW0], {}, None, False),
    "new": ("new", [], {}, None, True),
    "one_stage": ("new", ONE_STAGE, {"BP_STAGES": 1}, None, True),
    "three_stages": ("new", [], {"BP_STAGES": 3}, None, True),
    "reuse": ("new", [REUSE], {}, None, True),
    "no_staging": ("new", [NO_STAGING], {}, None, False),
    "no_staging_reuse": ("new", [NO_STAGING, REUSE], {}, None, False),
    "tile_8x8": ("new", [], {}, (8, 8), True),
    "tile_2x8": ("new", [], {}, (2, 8), True),
    "tile_1x8": ("new", [], {}, (1, 8), True),
    "tile_8x1": ("new", [], {}, (8, 1), True),
    "pairs_2_min3": ("new", [MIN_3], {"BP_PAIRS": 2}, None, True),
    "lines_4_min3": ("new", [MIN_3], {"BP_LINES": 4}, (8, 4), True),
}


def series(np, transform_matrix, shape):
    """The reconstruction's 41-tilt series for ``shape``, float32 M and
    M^-1."""
    center = np.divide(np.subtract(shape, 1), 2, dtype=np.float32)
    ms = np.stack([transform_matrix(rotation=(float(a), 0.0, 0.0),
                                    rotation_order="rzxz", center=center)
                   for a in np.arange(*TILTS)]).astype(np.float32)
    return ms, np.stack([np.linalg.inv(m) for m in ms]).astype(np.float32)


def main():
    # the package lives at the repository root, one level up
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("backproject_variants: no CUDA device", file=sys.stderr)
        return 1
    from voltools_tpu_torch.kernels import _build
    from voltools_tpu_torch.kernels import backproject as bp
    from voltools_tpu_torch.kernels.layout import row_pitch
    from voltools_tpu_torch.utils import transform_matrix

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    sources = {"new": open(_build.CSRC_DIR / "backproject.cu").read(),
               "baseline": open(os.path.join(
                   root, "tools", "backproject_baseline.cu")).read()}
    tmp = tempfile.mkdtemp()
    try:
        def layout(name):
            return {**bp.LAYOUT, **VARIANTS[name][2]}

        def build(name):
            src = VARIANTS[name][0]
            text = sources[src]
            for old, new in VARIANTS[name][1]:
                assert old in text, (name, old)
                text = text.replace(old, new)
            path = os.path.join(tmp, f"{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            lib = os.path.join(tmp, f"lib{name}.so")
            flags = _build.flags(layout(name) if src == "new" else None)
            proc = subprocess.run([_build.nvcc_path(), *flags, "-o", lib,
                                   path], capture_output=True, text=True,
                                  timeout=600)
            assert proc.returncode == 0, (name, proc.stdout, proc.stderr)
            return lib, [ln.strip() for ln in (proc.stdout + proc.stderr)
                         .splitlines() if "registers" in ln or "spill" in ln
                         or "Compiling entry" in ln]

        # tiles forced on the committed source share its build
        to_build = [n for n, v in VARIANTS.items()
                    if v[3] is None or v[1] or v[2]]
        with ThreadPoolExecutor(len(to_build)) as pool:
            built = dict(zip(to_build, pool.map(build, to_build)))
        libs = {}
        for name in VARIANTS:
            path, ptxas = built.get(name, built["new"])
            lib = ctypes.CDLL(path)
            if VARIANTS[name][0] == "baseline":
                fn = lib.backproject_baseline_launch
                fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [
                    ctypes.c_int] * 3 + [ctypes.c_void_p]
            else:
                fn = lib.backproject_launch
                fn.argtypes = bp.ARGTYPES
            fn.restype = ctypes.c_int
            libs[name] = lib
            if name in built:
                print(json.dumps({"variant": name, "ptxas": ptxas}),
                      flush=True)

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        misses = torch.zeros(1, dtype=torch.int32, device=dev)
        for shape in SHAPES:
            ms, minv = series(np, transform_matrix, shape)
            keep = [1, 2]
            table = bp.coefficients(minv, keep, True)
            coef = torch.from_numpy(table).to(dev)
            projs = torch.from_numpy(np.random.default_rng(3).random(
                (len(ms),) + shape[1:], dtype=np.float32)).to(dev)
            out = torch.empty(shape, device=dev)
            # the wrapper's pitched copy, made once here and timed apart
            pitched_projs = bp._tma_rows(projs)
            pitch = row_pitch(pitched_projs)
            tiles = {}
            for name, (src, _, _, forced, _) in VARIANTS.items():
                if src == "baseline":
                    continue
                tiles[name] = (bp.rowgather_tile(table, shape[0], shape[1],
                                                 shape[1])
                               if forced is None else bp.RowTile(
                                   *forced, max(1, bp.window_rows(
                                       table, *forced, shape[0], shape[1],
                                       shape[1]))))

            def launch(name):
                lib = libs[name]
                stream = torch.cuda.current_stream().cuda_stream
                if VARIANTS[name][0] == "baseline":
                    code = lib.backproject_baseline_launch(
                        projs.data_ptr(), *projs.shape, coef.data_ptr(),
                        keep[1], out.data_ptr(), *shape, stream)
                else:
                    code = lib.backproject_launch(
                        pitched_projs.data_ptr(), *projs.shape, pitch,
                        coef.data_ptr(), 1, keep[1], out.data_ptr(), *shape,
                        *tiles[name], bp.smem_bytes(*tiles[name],
                                                    layout(name)),
                        misses.data_ptr(), stream)
                assert code == 0, (name, code)

            launch("new")
            want = out.clone()
            plain = bp.plain_backproject(projs, minv, keep, shape, True)
            assert torch.equal(want, plain), (shape, "new != plain")
            del plain
            for name, (_, _, _, _, exact) in VARIANTS.items():
                misses.zero_()
                launch(name)
                if exact:
                    assert torch.equal(out, want), (shape, name)
                    assert int(misses.item()) == 0, (shape, name, "misses")

            def time_ms(name, reps):
                for _ in range(3):
                    launch(name)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(reps):
                    launch(name)
                end.record()
                torch.cuda.synchronize()
                return start.elapsed_time(end) / reps

            unaligned = projs[..., :-1].contiguous()   # never TMA-ready

            def time_pitched_copy(reps=20):
                for _ in range(3):
                    bp._tma_rows(unaligned)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(reps):
                    bp._tma_rows(unaligned)
                end.record()
                torch.cuda.synchronize()
                return start.elapsed_time(end) / reps

            reps = 20 if shape[1] <= 256 else 8
            runs = {name: [] for name in VARIANTS}
            for name in list(VARIANTS) + list(VARIANTS)[::-1]:
                runs[name].append(time_ms(name, reps))
            voxel_tilts = len(ms) * shape[0] * shape[1] * shape[2]
            line = {
                "shape": list(shape), "tilts": len(ms),
                "projections": list(projs.shape[1:]),
                "ms": {n: sum(r) / len(r) for n, r in runs.items()},
                "runs_ms": runs,
                "tiles": {n: list(t) for n, t in tiles.items()},
                "smem_bytes_per_cta": {
                    n: bp.smem_bytes(*t, layout(n)) for n, t in tiles.items()},
                "projection_row_pitch": pitch,
                "pitched_copy_ms": time_pitched_copy(),
                "bound_ms": max(4.0 * (shape[0] * shape[1] * shape[2]
                                       + projs.numel()) / HBM_BYTES_PER_S,
                                FLOPS * voxel_tilts / FP32_FLOPS) * 1e3,
                "no_contraction_floor_ms":
                    FLOPS * voxel_tilts / (FP32_FLOPS / 2) * 1e3,
                "equal_to_plain": [n for n, v in VARIANTS.items() if v[4]],
            }
            print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())

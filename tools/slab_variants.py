#!/usr/bin/env python3
"""Where the slab kernel's time goes, on one GPU.

Builds variants of ``voltools_tpu_torch/csrc/affine_slab.cu`` from edited
copies of the source (in a temporary directory; the repository is not
touched), and times each against the walk kernel on the same 250^3
matrices, with CUDA events, in one process:

* ``as_is``         -- the kernel as committed, ``planner.STAGES`` box
  buffers per CTA;
* ``stages_1``      -- the same build with one buffer: each box is loaded,
  waited for and computed in turn (no load overlaps the compute);
* ``stages_3``      -- the same build with three buffers (null where three
  boxes do not fit shared memory);
* ``no_load``       -- no TMA copy: each buffer's barrier completes its
  transaction count at once and the taps read stale shared memory: the
  compute alone;
* ``no_compute``    -- the boxes are staged, then each voxel stores one value
  of its box: the staging alone;
* ``tile_4x8x32_256`` -- both orders on (4, 8, 32) bricks of 256 threads
  (the tile before the per-order one);
* ``linear_threads_512`` -- trilinear with 2 threads along z a column;
* ``cubic_8x8x32`` -- cubic on (8, 8, 32) bricks, 512 threads;
* ``edge_path_only`` -- no interior fast path: every cubic warp takes the
  edge path (mirror or clip), as trilinear does;
* ``linear_fast_path`` -- trilinear takes the interior fast path too (its
  lanes past a brick's x end stay for the vote);
* ``per_voxel_box_test`` -- every voxel of the edge path tests its taps
  against the box, also where the brick's corners show that the box holds
  them all.

Each variant is planned with its own bricks.  A variant whose boxes do not
fit for every matrix of a set reads null there.  The variants that skip
work give wrong results and exist to be timed.  The walk kernel is timed on
the pitched volume the slab kernel reads (``walk``) and on the same voxels
contiguous (``walk_contiguous``).  Run from the repository root:

    python3 tools/slab_variants.py

It prints the card's name and power limit, each build's registers and
spills, then one JSON line per matrix set and order: ms per 250^3 matrix, one matrix per launch, for the walk
kernel and each variant, with the plans' box voxels per output voxel.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

STAGE_BOX_TMA = '''  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          shared_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(b)
      : "memory");'''
COMPUTE = "  const SharedSource shared{box, lo.z, lo.y, lo.x, e[1], e[2]};\n"
FAST_VOTE = "if (__all_sync(kWarpMask, interior || !inside)) {"


def tile(bz_linear, tz_linear, bz_cubic, tz_cubic):
    """A variant whose kernel has these bricks along z and threads along
    z, per order: its edits, and the bricks the planner plans it with."""
    edits = [("static constexpr int kBz = ORDER == 1 ? 8 : 4;",
              f"static constexpr int kBz = ORDER == 1 ? {bz_linear} : "
              f"{bz_cubic};"),
             ("static constexpr int kTz = ORDER == 1 ? 1 : 2;",
              f"static constexpr int kTz = ORDER == 1 ? {tz_linear} : "
              f"{tz_cubic};")]
    return edits, None, {1: (bz_linear, 8, 32), 3: (bz_cubic, 8, 32)}


# name: (edits of the source, stages, bricks the planner plans with)
VARIANTS = {
    "as_is": ([], None, None),
    "stages_1": ([], 1, None),
    "stages_3": ([], 3, None),
    "no_load": ([(STAGE_BOX_TMA,
                  '  asm volatile("mbarrier.complete_tx.shared::cta.b64 '
                  '[%0], %1;" ::"r"(b), "r"(bytes) : "memory");')],
                None, None),
    "no_compute": ([(COMPUTE,
                     "  {\n"
                     "    const int n_box = e[0] * e[1] * e[2];\n"
                     "    for (int u = br.u0; here && u <= br.u1; ++u) {\n"
                     "      out[((br.b * o0 + u) * o1 + v) *\n"
                     "              static_cast<long long>(o2) + w] =\n"
                     "          box[(threadIdx.y * 32 + threadIdx.x) % "
                     "n_box];\n"
                     "    }\n"
                     "    return;\n"
                     "  }\n" + COMPUTE)], None, None),
    "tile_4x8x32_256": tile(4, 1, 4, 1),
    "linear_threads_512": tile(8, 2, 4, 2),
    "cubic_8x8x32": tile(8, 1, 8, 2),
    "edge_path_only": ([(FAST_VOTE, "if (false) {")], None, None),
    "per_voxel_box_test": ([("    if (!lo.whole) {", "    if (true) {")],
                           None, None),
    "linear_fast_path": ([("  if constexpr (ORDER == 1) {\n"
                           "    if (w > br.w1) return;\n  }\n", ""),
                          ("    if constexpr (ORDER == 3) {\n      resample::"
                           "Weights<ORDER> wt;",
                           "    if constexpr (true) {\n      resample::"
                           "Weights<ORDER> wt;")], None, None),
}


def main():
    # the package lives at the repository root, one level up
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("slab_variants: no CUDA device", file=sys.stderr)
        return 1
    from voltools_tpu_torch.kernels import _build, planner
    from voltools_tpu_torch.kernels import affine_resample as walk_module
    from voltools_tpu_torch.kernels.layout import pitched
    from voltools_tpu_torch.kernels.planner import walk_patch
    from voltools_tpu_torch.utils import transform_matrix

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    source = open(_build.CSRC_DIR / "affine_slab.cu").read()
    # one build per distinct set of edits; variants that differ only in
    # their stages share it
    builds = {}
    for name, (edits, _, _) in VARIANTS.items():
        builds.setdefault(tuple(edits), name)
    build_of = {name: builds[tuple(edits)]
                for name, (edits, _, _) in VARIANTS.items()}
    builds = sorted(builds.values())
    tmp = tempfile.mkdtemp()
    try:
        shutil.copy(_build.CSRC_DIR / "resample_taps.cuh", tmp)

        def build(name):
            text = source
            for old, new in VARIANTS[name][0]:
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

        with ThreadPoolExecutor(len(builds)) as pool:
            built = dict(zip(builds, pool.map(build, builds)))
        libs = {}
        for name, (path, ptxas) in built.items():
            print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
            fn = ctypes.CDLL(path).affine_slab_launch
            fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_void_p]
                           + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            libs[name] = fn

        dev = torch.device("cuda", 0)
        shape = (250,) * 3
        rng = np.random.default_rng(0)   # bench.py's volume and rotations
        flat = torch.from_numpy(rng.random(shape, dtype=np.float64).astype(
            np.float32)).to(dev)
        vol = pitched(flat)
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

        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        out = torch.empty(shape, device=dev)

        def time_ms(fn, reps):
            for _ in range(3):
                fn(0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for i in range(reps):
                fn(i)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps

        def plans_for(ms, interp, bricks):
            """The plans of ``ms`` with ``bricks`` (the committed ones
            for None), and their box voxels per output voxel."""
            saved = planner.BRICK
            planner.BRICK = bricks or saved
            try:
                plans = [planner.slab_plan(m, shape, interp) for m in ms]
                return plans, [p and p.box_per_voxel for p in plans]
            finally:
                planner.BRICK = saved

        sets = {"tilt_axis_1": tilts(1), "tilt_axis_0": tilts(0),
                "random": rots}
        for set_name, ms in sets.items():
            for order, interp in ((1, "linear"), (3, "bspline")):
                plans, _ = plans_for(ms, interp, None)
                fit = [i for i, p in enumerate(plans) if p is not None]
                ms_dev = torch.from_numpy(ms).to(dev)
                # the walk kernel with the warp patch the planner picks
                patches = [walk_patch(m) for m in ms]
                row = {}
                for key, v in (("walk", vol), ("walk_contiguous", flat)):
                    row[key] = time_ms(
                        lambda i, v=v: walk_module.affine_resample(
                            v, ms_dev[fit[i % len(fit)]], order, out=out,
                            patch=patches[fit[i % len(fit)]]),
                        2 * len(fit))
                ratio = {}
                for name, (_, stages, bricks) in VARIANTS.items():
                    fn = libs[build_of[name]]
                    vplans, ratios = plans_for(ms, interp, bricks)
                    if any(vplans[j] is None for j in fit):
                        row[name] = None
                        continue
                    ratio[name] = float(np.median([ratios[j] for j in fit]))

                    def one(i, fn=fn, vplans=vplans,
                            stages=stages or planner.STAGES):
                        j = fit[i % len(fit)]
                        return fn(vol.data_ptr(), *shape, vol.stride(1),
                                  ms_dev[j].data_ptr(), 1, out.data_ptr(),
                                  *shape, *vplans[j].extents, stages, order,
                                  0, 0.0, counter.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
                    # every launch must go: where the boxes do not fit
                    # shared memory, the variant has no time
                    if any(one(i) != 0 for i in range(len(fit))):
                        row[name] = None
                        continue
                    row[name] = time_ms(one, 2 * len(fit))
                print(json.dumps({"set": set_name, "order": order,
                                  "matrices": len(fit),
                                  "ms_per_matrix": row,
                                  "median_box_per_voxel": ratio}),
                      flush=True)
    finally:
        shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())

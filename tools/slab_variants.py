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

The row path (``affine_rows_kernel``, for trilinear launches whose every
matrix leaves the row axis alone) has variants of its own, each timed in
both item orders (``segments``: x segment first, then matrix, then rows;
``matrices``: matrix first) beside the general kernel on the same launches
and the launches' least time at the published peaks
(``portbench/roofline``):

* ``rows_as_is``          -- the row kernel as committed;
* ``rows_segment_64``     -- a CTA covers 64 floats of x (a segment's
  source slab is twice as wide in L2);
* ``rows_patch_<u>x<v>``  -- a CTA's patch of output rows is u along the
  output's axis 0 (the rows each thread takes in turn) by v along axis 1
  (its threads along y), in place of the committed 4 x 32;
* ``rows_quads_<q>[_...]`` -- each thread takes q quads of 4 floats of a
  row (one committed), so a row's coordinates and weights serve more
  voxels;
* ``rows_offsets_32``     -- the source rows' offsets in 32 bits (right
  only for volumes under 2**31 floats: the (256, 512, 512) one is);
* ``<variant>_streaming_stores`` -- each of the others with the output
  stored with an evict-first hint (``__stcs``), so that it passes L2 by;
  ``<variant>_plain_stores`` without it, where the committed kernel has
  the hint;
* ``rows_no_load``        -- no source row is read: the stores alone.

The row sets are the benchmark's tomogram, (256, 512, 512) from the
41-tilt series about array axis 2 in the forward's launches of 8 (40
tilts; the 41st goes to the walk kernel), and 250^3 in launches of 34 and
7.  ``--rows`` runs the row path's part alone.

Each variant is planned with its own bricks.  A variant whose boxes do not
fit for every matrix of a set reads null there.  The variants that skip
work give wrong results and exist to be timed.  The walk kernel is timed on
the pitched volume the slab kernel reads (``walk``) and on the same voxels
contiguous (``walk_contiguous``).  Run from the repository root:

    python3 tools/slab_variants.py [--rows]

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


ROW_STORE = [("        *reinterpret_cast<float4*>(dst) =\n"
              "            make_float4(res[0], res[1], res[2], res[3]);"),
             "if (x + j < o2) dst[j] = res[j];"]
ROW_STCS = [("        __stcs(reinterpret_cast<float4*>(dst),\n"
             "               make_float4(res[0], res[1], res[2], res[3]));"),
            "if (x + j < o2) __stcs(dst + j, res[j]);"]


def row_shape(segment=32, quads=1, u=4, v=32):
    """The edits of a row kernel whose CTA covers ``segment`` floats of x,
    ``quads`` quads of them a thread, in patches of u x v output rows."""
    return [(f"constexpr int kRowSegment = 32;",
             f"constexpr int kRowSegment = {segment};"),
            ("constexpr int kRowQuads = 1;",
             f"constexpr int kRowQuads = {quads};"),
            ("constexpr int kRowThreadsY = 32;",
             f"constexpr int kRowThreadsY = {v};"),
            ("constexpr int kRowsPerThread = 4;",
             f"constexpr int kRowsPerThread = {u};")]


def row_stores(hint):
    """The edits that store the output with the evict-first hint, or
    without it, whichever the committed kernel does not."""
    old, new = (ROW_STORE, ROW_STCS) if hint else (ROW_STCS, ROW_STORE)
    return list(zip(old, new))


# name: edits of the source
ROW_VARIANTS = {
    "rows_as_is": [],
    "rows_segment_64": row_shape(segment=64),
    "rows_patch_2x32": row_shape(u=2),
    "rows_patch_8x32": row_shape(u=8),
    "rows_quads_2": row_shape(quads=2),
    "rows_quads_2_patch_4x64": row_shape(quads=2, v=64),
    "rows_quads_2_segment_64": row_shape(segment=64, quads=2),
    "rows_quads_4_segment_64": row_shape(segment=64, quads=4),
    "rows_offsets_32": [
        ("    long long row[4] = {0, 0, 0, 0};",
         "    int row[4] = {0, 0, 0, 0};"),
        ("        row[t] = taps.idx[0][iz] * plane +\n"
         "                 static_cast<long long>(taps.idx[1][iy]) * pitch;",
         "        row[t] = taps.idx[0][iz] * static_cast<int>(plane) +\n"
         "                 taps.idx[1][iy] * pitch;")],
    "rows_no_load": [("          if (ok[t]) {", "          if (false) {")],
}
ROW_ORDERS = {"segments": 1, "matrices": 0}


def build_variant(source, edits, tmp, name, nvcc, flags):
    """``source`` with ``edits`` made, built into ``tmp``: the library's
    path and ptxas's register and spill lines."""
    text = source
    for old, new in edits:
        assert old in text, (name, old)
        text = text.replace(old, new)
    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([nvcc, *flags, "-o", lib, path],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (name, proc.stdout, proc.stderr)
    return lib, [ln.strip() for ln in (proc.stdout + proc.stderr)
                 .splitlines() if "registers" in ln or "spill" in ln]


def rows_main(source, tmp):
    """The row path's variants in both item orders, beside the general
    kernel, on the tomogram's and 250^3's launches: one JSON line per set,
    ms per tilt."""
    import numpy as np
    import torch
    from portbench.roofline import inside_voxels, resample_launch_ms
    from portbench.traffic import tilt_series
    from voltools_tpu_torch.kernels import _build
    from voltools_tpu_torch.kernels.affine_slab import affine_slab
    from voltools_tpu_torch.kernels.layout import pitched, row_pitch
    from voltools_tpu_torch.kernels.planner import route
    from voltools_tpu_torch.volume import StaticVolume

    shutil.copy(_build.CSRC_DIR / "resample_taps.cuh", tmp)
    # each variant also with the other stores, the committed kernel's
    # hint or its absence turned round
    hinted = ROW_STCS[0] in source
    other = "_plain_stores" if hinted else "_streaming_stores"
    variants = dict(ROW_VARIANTS)
    for name, edits in ROW_VARIANTS.items():
        if name != "rows_no_load":
            variants[name.replace("_as_is", "") + other] = \
                edits + row_stores(not hinted)
    names = sorted(variants)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: build_variant(source, variants[n], tmp, n,
                                    _build.nvcc_path(), _build.NVCC_FLAGS),
            names)))
    fns = {}
    for name, (path, ptxas) in built.items():
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        fn = ctypes.CDLL(path).affine_rows_launch
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda", 0)
    # the row path's overflow counter (it counts matrices off the row rule)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    angles = np.arange(-60.0, 61.0, 3.0)
    for shape in ((256, 512, 512), (250, 250, 250)):
        chunk = StaticVolume.batch_chunk(shape)
        ms = tilt_series(angles, shape)
        # the forward's launches of two or more tilts (one goes to A)
        launches = [ms[p:p + chunk] for p in range(0, len(ms), chunk)
                    if len(ms[p:p + chunk]) >= 2]
        tilts = sum(len(c) for c in launches)
        gen = torch.Generator(device=dev).manual_seed(0)
        vol = pitched(torch.rand(shape, generator=gen, device=dev))
        out = torch.empty((chunk,) + shape, device=dev)
        plans = [route(c, shape, "linear").plan for c in launches]
        assert all(p is not None and p.rows for p in plans)
        mats = [torch.from_numpy(c).to(dev) for c in launches]
        least = sum(resample_launch_ms(
            1, shape, shape, [inside_voxels(shape, m, device=dev)
                              for m in c])[0] for c in launches)

        def time_ms(run, reps=5):
            run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                run()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps / tilts

        def general():
            for c, m, p in zip(launches, mats, plans):
                affine_slab(vol, m, 1, out=out[:len(c)], plan=p,
                            _force_general=True)

        row = {"general": time_ms(general)}
        want = out.clone()
        for name, fn in fns.items():
            for order, code in ROW_ORDERS.items():
                def rows(fn=fn, code=code):
                    for c, m in zip(launches, mats):
                        err = fn(vol.data_ptr(), *shape, row_pitch(vol),
                                 m.data_ptr(), len(c), out.data_ptr(),
                                 *shape, 0, 0.0, code, counter.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
                        assert err == 0, (name, err)
                row[f"{name}.{order}"] = time_ms(rows)
                if name != "rows_no_load":
                    # the last launch's output, bit for bit the general
                    # kernel's
                    assert torch.equal(out, want), (name, order)
        print(json.dumps({"set": "tilt_series_about_axis_2",
                          "shape": list(shape), "tilts": tilts,
                          "launches": [len(c) for c in launches],
                          "least_ms_per_tilt": least / tilts,
                          "ms_per_tilt": row}), flush=True)
    return 0


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
    if "--rows" in sys.argv[1:]:
        tmp = tempfile.mkdtemp()
        try:
            return rows_main(source, tmp)
        finally:
            shutil.rmtree(tmp)
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
            return build_variant(source, VARIANTS[name][0], tmp, name,
                                 _build.nvcc_path(), _build.NVCC_FLAGS)

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

#!/usr/bin/env python3
"""What bounds the per-slab partial sample D, and what each part of its
design buys, on one GPU.

Builds variants of ``voltools_tpu_torch/csrc/partial_sample.cu`` from
edited copies of the source, and ``tools/partial_sample_baseline.cu`` (the
kernel before its redesign), in a temporary directory (the repository is
not touched); checks that each variant that computes the function gives
the committed kernel's output, and the plain version's, bit for bit; and
times each with CUDA events around back-to-back launches through the C
entries (no wrapper), in one process, in turns (the list, then the list
reversed).

D1, one rotation of the stream body at 250^3 on 4 shards (a random
'sxyz' rotation about the centre, linear and cubic, 'constant'):

* ``baseline``           -- ``tools/partial_sample_baseline.cu``: 16
  launches, a launch per shard and slab, a thread a voxel forming its
  coordinates and taps at every launch, warps along x;
* ``per_step``           -- the committed per-step entry, the same 16
  launches (the design the stream body keeps for distinct devices): the
  ring entry's kernel over one slab, its sum starting from the
  accumulator, where a voxel whose z stencil lies inside the volume and
  misses the slab returns before it forms its taps;
* ``per_step_all_taps``  -- the per-step entry without that return;
* ``ring``               -- the committed ring entry: 4 launches, a
  shard's slabs in one, each voxel's coordinates and taps formed once, a
  warp a (4, 8) patch of output voxels;
* ``ring_make_taps``     -- the ring entry forming its taps as
  ``make_taps`` does, a mirror (a remainder) per cubic 'constant' tap,
  where the committed entry takes an axis whose taps lie inside the
  volume as they stand (linear: the same code);
* ``ring_rows``, ``ring_patch_2x16``, ``ring_patch_8x4`` -- the ring entry
  with a warp's 32 voxels along x, or in (2, 16) or (8, 4) patches.

D2, one sweep of the mesh SIRT's forward (the reconstruction's 41 tilts,
'rzxz' at position 0 about the centre, projection axis 0, a launch for
each of 4 shards of a 250^3 volume):

* ``baseline``           -- the kernel before its redesign: a thread a
  ray, its three coordinates and 8 taps at every plane;
* ``general``            -- the committed general kernel (``line`` 0);
* ``general_4_taps``     -- the general kernel without the 4 taps at x + 1
  (weight 0 on this geometry): coordinates per ray, 4 taps;
* ``line``               -- the committed line path: two warps a line of
  250 rays, its coordinates once a plane in each, 4 rays a lane read as
  column pairs (8-byte loads), 4 taps a sample;
* ``line_scalar``        -- the line path with 4-byte loads, a ray at a
  time;
* ``line_rays_8``, ``line_rays_16``, ``line_scalar_rays_8`` -- 8 or 16
  rays a lane (a warp a line of up to 256 or 512 rays);
* ``line_8_taps``        -- the line path reading the 4 taps at b + 1 too,
  weighted 0 and summed in the general kernel's order;
* ``line_staged``        -- the line path with each lane's taps written to
  shared memory and read back by the same lane (a staging hop and nothing
  else: no tap is read by two lanes, so there is no reuse to gain, and a
  lane needs no barrier to read its own writes);
* ``line_no_loads``      -- the line path with each load replaced by a
  value formed from its address: its arithmetic and instructions alone (its
  output is not the function's and is not checked).

Run from the repository root:

    python3 tools/partial_variants.py

It prints the card's name and power limit, one JSON line per built
variant with nvcc's ``-Xptxas -v`` lines (registers, spills), then one
JSON line for D1 (per order) and one for D2: ms per rotation or sweep
for each variant, each run of the turns apart.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

SIZE = 250
SHARDS = 4
TILTS = (-60.0, 61.0, 3.0)

# the per-step entry without its z-first return: every inside voxel forms
# its taps before it tests the slab, as the kernel before its redesign did
ALL_TAPS = ("""    if (miss) return;
""", "")
GENERAL_4_TAPS = [
    ("    val = __fadd_rn(val, slab_tap(a, z, y, x + 1, "
     "__fmul_rn(wzy00, fx)));\n", ""),
    ("    val = __fadd_rn(val, slab_tap(a, z, y + 1, x + 1, "
     "__fmul_rn(wzy01, fx)));\n", ""),
    ("    val = __fadd_rn(val, slab_tap(a, z + 1, y, x + 1, "
     "__fmul_rn(wzy10, fx)));\n", ""),
    ("    val = __fadd_rn(val,\n                    slab_tap(a, z + 1, y + 1, "
     "x + 1, __fmul_rn(wzy11, fx)));\n", "")]
LINE_SUM = """        acc[k * VEC + e] = __fadd_rn(
            acc[k * VEC + e],
            __fadd_rn(__fadd_rn(__fadd_rn(t00, t01), t10), t11));"""
# the taps at b + 1 too, weight 0, in the general kernel's order
EIGHT_TAPS = (LINE_SUM, """        const float* tb = t + e + 1;
        const bool x1 = b0 + k * kLanes * VEC + e + 1 < a.nb;
        float val = t00;
        val = __fadd_rn(val, v00 && x1 ? __fmul_rn(__ldg(tb), 0.0f) : 0.0f);
        val = __fadd_rn(val, t01);
        val = __fadd_rn(val, v01 && x1 ? __fmul_rn(__ldg(tb + qstep), 0.0f)
                                       : 0.0f);
        val = __fadd_rn(val, t10);
        val = __fadd_rn(val, v10 && x1 ? __fmul_rn(__ldg(tb + plane), 0.0f)
                                       : 0.0f);
        val = __fadd_rn(val, t11);
        val = __fadd_rn(val, v11 && x1
                                 ? __fmul_rn(__ldg(tb + plane + qstep), 0.0f)
                                 : 0.0f);
        acc[k * VEC + e] = __fadd_rn(acc[k * VEC + e], val);""")
# each lane's taps through shared memory and back (volatile: the hop is
# made, not forwarded in registers)
STAGED = ("""      row_taps<VEC>(t + plane + qstep, v11, x11);
""", """      row_taps<VEC>(t + plane + qstep, v11, x11);
      {
        __shared__ float stage[kWarps][4 * VEC][kLanes];
        volatile float* s4 = &stage[threadIdx.y][0][threadIdx.x];
        for (int e = 0; e < VEC; ++e) {
          s4[(4 * e) * kLanes] = x00[e];
          s4[(4 * e + 1) * kLanes] = x01[e];
          s4[(4 * e + 2) * kLanes] = x10[e];
          s4[(4 * e + 3) * kLanes] = x11[e];
        }
        for (int e = 0; e < VEC; ++e) {
          x00[e] = s4[(4 * e) * kLanes];
          x01[e] = s4[(4 * e + 1) * kLanes];
          x10[e] = s4[(4 * e + 2) * kLanes];
          x11[e] = s4[(4 * e + 3) * kLanes];
        }
      }
""")
# each load replaced by a value formed from its address
NO_LOADS = [
    ("? __ldg(reinterpret_cast<const float2*>(p))",
     "? make_float2(address_value(p), address_value(p + 1))"),
    ("    x[0] = valid ? __ldg(p) : 0.0f;",
     "    x[0] = valid ? address_value(p) : 0.0f;"),
    ("// VEC taps of one row at consecutive columns", """__device__ __forceinline__ float address_value(const float* p) {
  return __int_as_float(
      static_cast<int>(reinterpret_cast<uintptr_t>(p) >> 2) & 0x3effffff);
}

// VEC taps of one row at consecutive columns""")]
SCALAR = ("    const bool pairs = AXIS != 2 && a.w % 2 == 0 &&",
          "    const bool pairs = false && a.w % 2 == 0 &&")


def rays(n):
    return ("constexpr int kLineRays = 4;", f"constexpr int kLineRays = {n};")


# the taps of resample_taps.cuh's make_taps: a remainder per cubic tap
MAKE_TAPS = ("""  voxel_taps<ORDER, CONSTANT>(s, n, &t);
  // the plain chain's accumulator""", """  resample::make_taps<ORDER, CONSTANT>(s, n, &t);
  // the plain chain's accumulator""")


def patch_rows(n):
    return ("constexpr int kPatchRows = 4;", f"constexpr int kPatchRows = {n};")


# name: (source: "new" or "baseline", edits (old, new), whether its output
# is the function's)
D1_VARIANTS = {
    "baseline": ("baseline", [], True),
    "per_step": ("new", [], True),
    "per_step_all_taps": ("new", [ALL_TAPS], True),
    "ring": ("new", [], True),
    "ring_make_taps": ("new", [MAKE_TAPS], True),
    "ring_rows": ("new", [patch_rows(1)], True),
    "ring_patch_2x16": ("new", [patch_rows(2)], True),
    "ring_patch_8x4": ("new", [patch_rows(8)], True),
}
D2_VARIANTS = {
    "baseline": ("baseline", [], True),
    "general": ("new", [], True),
    "general_4_taps": ("new", GENERAL_4_TAPS, True),
    "line": ("new", [], True),
    "line_scalar": ("new", [SCALAR], True),
    "line_rays_8": ("new", [rays(8)], True),
    "line_rays_16": ("new", [rays(16)], True),
    "line_scalar_rays_8": ("new", [SCALAR, rays(8)], True),
    "line_8_taps": ("new", [EIGHT_TAPS], True),
    "line_staged": ("new", [STAGED], True),
    "line_no_loads": ("new", NO_LOADS, False),
}


def main():
    # the package lives at the repository root, one level up
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("partial_variants: no CUDA device", file=sys.stderr)
        return 1
    from voltools_tpu_torch.kernels import _build
    from voltools_tpu_torch.kernels import partial_sample as ps
    from voltools_tpu_torch.parallel.sharded import _shifted
    from voltools_tpu_torch.utils import transform_matrix

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    sources = {"new": open(_build.CSRC_DIR / "partial_sample.cu").read(),
               "baseline": open(os.path.join(
                   root, "tools", "partial_sample_baseline.cu")).read()}
    builds = {}   # a build per distinct (source, edits)
    for variants in (D1_VARIANTS, D2_VARIANTS):
        for name, (src, edits, _) in variants.items():
            key = "new" if src == "new" and not edits else (
                "baseline" if src == "baseline" else name)
            builds[key] = (src, edits)
    tmp = tempfile.mkdtemp()
    try:
        def build(key):
            src, edits = builds[key]
            text = sources[src]
            for old, new in edits:
                assert old in text, (key, old)
                text = text.replace(old, new)
            path = os.path.join(tmp, f"{key}.cu")
            with open(path, "w") as f:
                f.write(text)
            lib = os.path.join(tmp, f"lib{key}.so")
            proc = subprocess.run(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                 str(_build.CSRC_DIR), "-o", lib, path],
                capture_output=True, text=True, timeout=600)
            assert proc.returncode == 0, (key, proc.stdout, proc.stderr)
            return lib, [ln.strip() for ln in (proc.stdout + proc.stderr)
                         .splitlines() if "registers" in ln or "spill" in ln
                         or "Compiling entry" in ln]

        with ThreadPoolExecutor(len(builds)) as pool:
            built = dict(zip(builds, pool.map(build, builds)))
        libs = {}
        for key, (path, ptxas) in built.items():
            lib = ctypes.CDLL(path)
            if key == "baseline":
                lib.partial_sample_baseline_launch.argtypes = \
                    ps.SAMPLE_ARGTYPES
                lib.partial_project_baseline_launch.argtypes = (
                    ps.PROJECT_ARGTYPES[:11] + ps.PROJECT_ARGTYPES[12:])
            else:
                lib.partial_sample_launch.argtypes = ps.SAMPLE_ARGTYPES
                lib.partial_sample_ring_launch.argtypes = ps.RING_ARGTYPES
                lib.partial_project_launch.argtypes = ps.PROJECT_ARGTYPES
            libs[key] = lib
            print(json.dumps({"variant": key, "ptxas": ptxas}), flush=True)

        def lib_of(variants, name):
            src, edits, _ = variants[name]
            return libs["new" if src == "new" and not edits else (
                "baseline" if src == "baseline" else name)]

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        shape = (SIZE,) * 3
        local = -(-SIZE // SHARDS)
        rng = np.random.default_rng(0)
        vol = np.zeros((local * SHARDS,) + shape[1:], np.float32)
        vol[:SIZE] = rng.random(shape, dtype=np.float32)
        slabs = [torch.from_numpy(vol[i * local:(i + 1) * local].copy())
                 .to(dev) for i in range(SHARDS)]

        def time_ms(fn, reps):
            for _ in range(3):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps

        # ---------------------------------------------------------- D1
        center = tuple(s / 2 for s in shape)
        m = np.asarray(transform_matrix(
            rotation=tuple(rng.uniform(-180, 180, 3)), rotation_order="sxyz",
            center=center), np.float32)
        out_shape = (local,) + shape[1:]
        shifted = [_shifted(m, np.float32(i * local)) for i in range(SHARDS)]
        outs = [torch.empty(out_shape, device=dev) for _ in range(SHARDS)]
        for order in (1, 3):
            def d1(name):
                lib = lib_of(D1_VARIANTS, name)
                stream = torch.cuda.current_stream().cuda_stream
                for i in range(SHARDS):
                    ring = [(i - k) % SHARDS for k in range(SHARDS)]
                    rows = np.ascontiguousarray(shifted[i][:3])
                    if name.startswith("ring"):
                        code = lib.partial_sample_ring_launch(
                            (ctypes.c_void_p * SHARDS)(
                                *(slabs[j].data_ptr() for j in ring)),
                            (ctypes.c_int * SHARDS)(
                                *(j * local for j in ring)), SHARDS, local,
                            *shape, rows.ctypes.data, outs[i].data_ptr(),
                            *out_shape, order, 0, 0.0, stream)
                        assert code == 0, (name, code)
                        continue
                    fn = (lib.partial_sample_baseline_launch
                          if name == "baseline" else lib.partial_sample_launch)
                    outs[i].zero_()
                    for k, j in enumerate(ring):
                        code = fn(slabs[j].data_ptr(), local, j * local,
                                  *shape, rows.ctypes.data,
                                  outs[i].data_ptr(), *out_shape, order, 0,
                                  int(k == SHARDS - 1), 0.0, stream)
                        assert code == 0, (name, code)

            want = [ps.plain_partial_ring(
                [slabs[j] for j in [(i - k) % SHARDS
                                    for k in range(SHARDS)]],
                [j * local for j in [(i - k) % SHARDS
                                     for k in range(SHARDS)]],
                shifted[i], shape, order, "constant", out_shape)
                for i in range(SHARDS)]
            for name in D1_VARIANTS:
                d1(name)
                assert all(torch.equal(o, w) for o, w in zip(outs, want)), (
                    "D1", order, name)
            del want
            runs = {name: [] for name in D1_VARIANTS}
            for name in list(D1_VARIANTS) + list(D1_VARIANTS)[::-1]:
                runs[name].append(time_ms(lambda: d1(name), 10))
            print(json.dumps({
                "kernel": "D1", "order": order, "shape": list(shape),
                "shards": SHARDS, "what": "ms per rotation: the launches "
                "of all 4 shards (per-step entries 16, the ring 4; the "
                "per-step outputs zeroed first, as the stream body "
                "allocates them), back to back through the C entries",
                "ms": {n: sum(r) / len(r) for n, r in runs.items()},
                "runs_ms": runs,
                "equal_to_plain": list(D1_VARIANTS)}), flush=True)

        # ---------------------------------------------------------- D2
        c = np.divide(np.subtract(shape, 1), 2, dtype=np.float32)
        ms = np.stack([transform_matrix(rotation=(float(a), 0.0, 0.0),
                                        rotation_order="rzxz", center=c)
                       for a in np.arange(*TILTS)]).astype(np.float32)
        assert ps.line_axis(ms, 0) == 2
        rows = torch.from_numpy(np.ascontiguousarray(ms[:, :3])).to(dev)
        projs = [torch.empty((len(ms),) + shape[1:], device=dev)
                 for _ in range(SHARDS)]

        def d2(name):
            lib = lib_of(D2_VARIANTS, name)
            stream = torch.cuda.current_stream().cuda_stream
            for i in range(SHARDS):
                off = float(np.float32(i * local))
                if name == "baseline":
                    code = lib.partial_project_baseline_launch(
                        slabs[i].data_ptr(), *slabs[i].shape,
                        rows.data_ptr(), len(ms), off, *shape, 0,
                        projs[i].data_ptr(), stream)
                else:
                    code = lib.partial_project_launch(
                        slabs[i].data_ptr(), *slabs[i].shape,
                        rows.data_ptr(), len(ms), off, *shape, 0,
                        0 if name.startswith("general") else 2,
                        projs[i].data_ptr(), stream)
                assert code == 0, (name, code)

        d2("general")
        want = [p.clone() for p in projs]
        for i in range(SHARDS):
            x = slabs[i]
            off = float(np.float32(i * local))
            plain = ps.plain_partial_project(x, ms, off, shape, 0)
            largest = float(ps.plain_partial_project(x.abs(), ms, off, shape,
                                                     0).max())
            assert float((want[i] - plain).abs().max()) <= ps.sum_order_atol(
                SIZE, largest), ("D2 general against plain", i)
            del plain
        for name, (_, _, exact) in D2_VARIANTS.items():
            d2(name)
            if exact:
                assert all(torch.equal(p, w) for p, w in zip(projs, want)), (
                    "D2", name)
        runs = {name: [] for name in D2_VARIANTS}
        for name in list(D2_VARIANTS) + list(D2_VARIANTS)[::-1]:
            runs[name].append(time_ms(lambda: d2(name), 5))
        print(json.dumps({
            "kernel": "D2", "shape": list(shape), "shards": SHARDS,
            "tilts": len(ms), "what": "ms per sweep: a launch for each "
            "of 4 shards, back to back through the C entry",
            "ms": {n: sum(r) / len(r) for n, r in runs.items()},
            "runs_ms": runs,
            "equal_to_general": [n for n, v in D2_VARIANTS.items()
                                 if v[2]]}), flush=True)
    finally:
        shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())

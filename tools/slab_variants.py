#!/usr/bin/env python3
"""Where the slab kernel's time goes, on one GPU.

Builds variants of ``voltools_tpu_torch/csrc/affine_slab.cu`` from edited
copies of the source (in a temporary directory; the repository is not
touched), and times each against the walk kernel on the same 250^3
matrices, with CUDA events, in one process:

* ``as_is``          -- the kernel as committed;
* ``plain_loads``    -- the box staged with one ``__ldg`` and store per
  element instead of ``cp.async``;
* ``no_carveout``    -- without the request for the largest shared-memory
  carveout;
* ``no_load``        -- the box is not staged (taps read stale shared
  memory): the compute alone;
* ``no_compute``     -- the box is staged, then each voxel stores one value
  of it: the staging alone;
* ``no_box_check``   -- every voxel reads its taps from the box, unchecked;
* ``taps_from_global`` -- the box is staged but the taps are read from
  global memory, as the walk kernel reads them.

The variants that skip work give wrong results and exist to be timed.  Run
from the repository root:

    python3 tools/slab_variants.py

It prints the card's name and power limit, then one JSON line per matrix
set: ms per 250^3 matrix, one matrix per launch, for the walk kernel and
each variant.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

VARIANTS = {
    "as_is": [],
    "plain_loads": [(
        "      __pipeline_memcpy_async(dst + xx, src + xx, sizeof(float));",
        "      dst[xx] = __ldg(src + xx);")],
    "no_carveout": [(
        "  return cudaFuncSetAttribute(kernel,\n"
        "                              cudaFuncAttributePreferredSharedMemoryCarveout,\n"
        "                              cudaSharedmemCarveoutMaxShared);",
        "  return cudaSuccess;")],
    "no_load": [(
        "      __pipeline_memcpy_async(dst + xx, src + xx, sizeof(float));",
        "      ;")],
    "no_compute": [(
        "  const int v = v0 + threadIdx.y;\n",
        "  {\n"
        "    const int v = v0 + threadIdx.y, w = w0 + threadIdx.x;\n"
        "    const int n_box = max(1, cnt[0] * cnt[1] * cnt[2]);\n"
        "    if (v <= v1 && w <= w1) {\n"
        "      for (int u = u0; u <= u1; ++u) {\n"
        "        out[((static_cast<long long>(b) * o0 + u) * o1 + v) *\n"
        "                static_cast<long long>(o2) + w] =\n"
        "            box[(threadIdx.y * kBx + threadIdx.x) % n_box];\n"
        "      }\n"
        "    }\n"
        "    return;\n"
        "  }\n"
        "  const int v = v0 + threadIdx.y;\n")],
    "no_box_check": [("    if (in_box) {", "    if (true) {")],
    "taps_from_global": [(
        "      *dst = resample::tap_sum<ORDER, CONSTANT>(taps, shared);",
        "      *dst = resample::tap_sum<ORDER, CONSTANT>(taps, global);")],
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
    from voltools_tpu_torch.kernels import _build
    from voltools_tpu_torch.kernels import affine_resample as walk_module
    from voltools_tpu_torch.kernels.planner import choose_plan
    from voltools_tpu_torch.utils import transform_matrix

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    source = open(_build.CSRC_DIR / "affine_slab.cu").read()
    tmp = tempfile.mkdtemp()
    try:
        shutil.copy(_build.CSRC_DIR / "resample_taps.cuh", tmp)

        def build(name):
            text = source
            for old, new in VARIANTS[name]:
                assert old in text, (name, old)
                text = text.replace(old, new)
            path = os.path.join(tmp, f"{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            lib = os.path.join(tmp, f"lib{name}.so")
            subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                            lib, path], check=True, capture_output=True,
                           timeout=600)
            return lib

        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            paths = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
        launch = {}
        for name, path in paths.items():
            fn = ctypes.CDLL(path).affine_slab_launch
            fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                           + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                           + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            launch[name] = fn

        dev = torch.device("cuda", 0)
        shape = (250,) * 3
        rng = np.random.default_rng(0)   # bench.py's volume and rotations
        vol = torch.from_numpy(rng.random(shape, dtype=np.float64).astype(
            np.float32)).to(dev)
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

        sets = {"tilt_axis_1": tilts(1), "tilt_axis_0": tilts(0),
                "random": rots}
        for set_name, ms in sets.items():
            for order, interp in ((1, "linear"), (3, "bspline")):
                plans = [choose_plan(m, shape, interp) for m in ms]
                fit = [i for i, p in enumerate(plans) if p is not None]
                ms_dev = torch.from_numpy(ms).to(dev)
                row = {"matrices": len(fit), "walk": time_ms(
                    lambda i: walk_module.affine_resample(
                        vol, ms_dev[fit[i % len(fit)]], order, out=out),
                    2 * len(fit))}
                for name, fn in launch.items():
                    def one(i, fn=fn):
                        j = fit[i % len(fit)]
                        code = fn(vol.data_ptr(), *shape,
                                  ms_dev[j].data_ptr(), 1, out.data_ptr(),
                                  *shape, *plans[j].extents, order, 0, 0.0,
                                  counter.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
                        assert code == 0, (name, code)
                    row[name] = time_ms(one, 2 * len(fit))
                print(json.dumps({"set": set_name, "order": order,
                                  "ms_per_matrix": row}), flush=True)
    finally:
        shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``voltools_tpu_torch``) on one GPU.

Run from the repository root, on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It imports torch, numpy, scipy and the port only (never JAX, never
``voltools_tpu``), and prints one JSON line per phase, flushed:

1. card   -- the ``nvidia-smi`` name and power limit, torch, CUDA and nvcc
   versions;
2. build  -- ``nvcc`` builds ``voltools_tpu_torch/csrc/affine_resample.cu``
   (timed) and the library is loaded;
3. parity -- the kernel against its plain torch version on the card: order
   {1, 3} x mode {constant, border} x cval {0, 1.5}, random 'sxyz'
   rotations about size/2 plus a translate, a scale and a shear, on 250^3,
   (40, 48, 56) and shapes with an extent of 1; a batch of 16 and a write
   into a preallocated tensor.  atol 5e-5 off knife edges;
4. main   -- the main path at 250^3 float32, through the public API:
   ``StaticVolume`` 'linear' and 'filt_bspline' on 'cuda', ``.affine`` over
   16 random rotations and ``.affine_batch`` of the same 16, and the
   one-shot ``affine(..., 'filt_bspline', device='cuda')``.  The launch
   counter is set to 0 just before and read just after; results are held
   against the plain version and the scipy.ndimage oracles;
5. times  -- CUDA-event times after warm-up: kernel, batch, prefilter,
   one-shot and plain version, beside the kernel's bound (the larger of
   its bytes over the memory rate and its least arithmetic, for this run's
   matrices, over the fp32 rate) and
   ``torch.nn.functional.grid_sample`` (timed only; the port never calls
   it).

The line before the last is the ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits 1 before printing a result.
"""

import json
import subprocess
import sys
import time

SIZE = 250                 # the reference benchmark's volume, 250^3 float32
N_ROT = 16                 # rotations on the main path
ATOL = 5e-5                # kernel vs plain version, off knife edges
SCIPY_ATOL = 1e-4          # main path vs scipy.ndimage, off knife edges
KNIFE_TOL = 1e-4           # |coordinate - round(coordinate)| masked below
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_FLOPS = 67e12         # H100 SXM fp32 rate outside the tensor cores
# the least floating-point work of the function per output voxel that lands
# inside the source (an FMA counts 2): 3 coordinates of 3 FMAs (18), 3
# fractions, the weights (1 per axis for linear, 14 for cubic) and a
# separable contraction of k^3 + k^2 + k FMAs (14 linear, 84 cubic).  A
# voxel outside the source needs only its coordinates.
FLOPS_INSIDE = {1: 18 + 3 + 3 * 1 + 2 * 14, 3: 18 + 3 + 3 * 14 + 2 * 84}
FLOPS_OUTSIDE = 18

CARD = {}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields, **CARD}), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def knife_mask(torch, m, shape, device):
    """True where a source coordinate lies within KNIFE_TOL of an integer
    (rows that are exactly integral have no knife edge)."""
    mm = torch.as_tensor(m, dtype=torch.float64, device=device)
    grids = [torch.arange(n, dtype=torch.float64, device=device)
             for n in shape]
    i, j, k = (grids[0].view(-1, 1, 1), grids[1].view(1, -1, 1),
               grids[2].view(1, 1, -1))
    near = torch.zeros(shape, dtype=torch.bool, device=device)
    for a in range(3):
        row = mm[a]
        if bool((row == torch.round(row)).all()) and int(
                (row[:3] != 0).sum()) <= 1:
            continue
        s = row[0] * i + row[1] * j + row[2] * k + row[3]
        near |= (s - torch.round(s)).abs() < KNIFE_TOL
    return near


def errors(torch, got, want, m):
    """(max error off knife edges, max error everywhere)."""
    diff = (got.double() - want.double()).abs()
    assert torch.isfinite(got).all(), "non-finite kernel output"
    near = knife_mask(torch, m, tuple(got.shape), got.device)
    return (float(torch.where(near, 0.0, diff).max()), float(diff.max()))


def matrix_set(np, transform_matrix, shape, seed):
    """Two random 'sxyz' rotations about size/2, a translate, a scale and
    a shear."""
    rng = np.random.default_rng(seed)
    center = tuple(s / 2 for s in shape)
    ms = [transform_matrix(rotation=tuple(rng.uniform(-180, 180, 3)),
                           rotation_order="sxyz", center=center)
          for _ in range(2)]
    ms.append(transform_matrix(translation=(2.37, -1.41, 0.73)))
    ms.append(transform_matrix(scale=(0.87, 1.09, 0.93), center=center))
    ms.append(transform_matrix(shear=(0.11, -0.07, 0.19), center=center))
    return np.stack(ms).astype(np.float32)


def time_ms(torch, fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` back-to-back runs."""
    for _ in range(warmup):
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


def inside_voxels(torch, vt, shape, mats):
    """Output voxels per matrix whose source point lies inside the volume
    ('constant' mode), from the coordinates the kernel computes."""
    counts = []
    for m in mats:
        s = vt.ops.affine_coords(shape, m)
        inside = torch.ones(shape, dtype=torch.bool, device=s.device)
        for a in range(3):
            inside &= (s[a] >= 0) & (s[a] <= shape[a] - 1)
        counts.append(int(inside.sum()))
    return counts


def bound_ms(order, in_shape, out_shape, inside, per_launch):
    """Least time per matrix on the card for matrices with ``inside``
    in-source output voxels each, ``per_launch`` of them per launch: for
    each launch the larger of the bytes moved (the source read once, the
    outputs written once) over the memory rate and the work of
    FLOPS_INSIDE / FLOPS_OUTSIDE over the fp32 rate.  Returns (ms per
    matrix, 'bytes' or 'operations', whichever is the larger in sum)."""
    vin = in_shape[0] * in_shape[1] * in_shape[2]
    vout = out_shape[0] * out_shape[1] * out_shape[2]
    total = t_bytes = t_ops = 0.0
    for first in range(0, len(inside), per_launch):
        group = inside[first:first + per_launch]
        tb = 4.0 * (vin + len(group) * vout) / HBM_BYTES_PER_S
        to = sum(FLOPS_INSIDE[order] * c + FLOPS_OUTSIDE * (vout - c)
                 for c in group) / FP32_FLOPS
        total += max(tb, to)
        t_bytes += tb
        t_ops += to
    return (total / len(inside) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1

    import numpy as np
    from scipy import ndimage

    import voltools_tpu_torch as vt
    from voltools_tpu_torch.kernels import _build
    from voltools_tpu_torch.kernels import affine_resample as K
    from voltools_tpu_torch.ops.prefilter import bspline_prefilter
    from voltools_tpu_torch.ops.sampling import affine_sample
    from voltools_tpu_torch.utils import transform_matrix

    kernel = K.affine_resample
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---------------------------------------------------------- 1. card
    smi = card_line()
    print(smi, flush=True)
    CARD["card"] = smi
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit("card", torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0], kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # --------------------------------------------------------- 2. build
    cached = _build.library_path(K.NAME).is_file()
    t0 = time.perf_counter()
    K._library()
    seconds = time.perf_counter() - t0
    log = _build.BUILD_LOG.get(K.NAME, (None, ""))[1]
    emit("build", source=K.SOURCE, seconds=seconds, built_now=not cached,
         flags=" ".join(_build.NVCC_FLAGS),
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])

    # ------------------------------------------ 3. kernel vs plain version
    rng = np.random.default_rng(1)
    worst = {1: 0.0, 3: 0.0}
    worst_all = 0.0
    shapes = [(SIZE,) * 3, (40, 48, 56), (1, 64, 80), (37, 1, 29)]
    for shape in shapes:
        vol = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        ms = matrix_set(np, transform_matrix, shape, seed=shape[0])
        ms_dev = torch.from_numpy(ms).to(dev)
        for order in (1, 3):
            interp = "linear" if order == 1 else "bspline"
            for mode in ("constant", "border"):
                for cval in (0.0, 1.5):
                    errs = []
                    for i in range(len(ms)):
                        got = kernel(vol, ms_dev[i], order, mode, cval)
                        want = affine_sample(vol, ms_dev[i], interp, mode,
                                             cval, prefiltered=True)
                        off, every = errors(torch, got, want, ms[i])
                        errs.append(off)
                        worst[order] = max(worst[order], off)
                        worst_all = max(worst_all, every)
                        assert off <= ATOL, (shape, order, mode, cval, i, off)
                    torch.cuda.synchronize()
                    emit("parity", shape=list(shape), order=order, mode=mode,
                         cval=cval, max_abs_err=errs, atol=ATOL)

    vol = torch.from_numpy(rng.random((SIZE,) * 3).astype(np.float32)).to(dev)
    ms = np.stack([matrix_set(np, transform_matrix, (SIZE,) * 3, seed=s)[:2]
                   for s in range(8)]).reshape(-1, 4, 4)
    ms_dev = torch.from_numpy(ms).to(dev)
    for order, interp in ((1, "linear"), (3, "bspline")):
        batch = kernel(vol, ms_dev, order)
        errs = []
        for i in range(len(ms)):
            want = affine_sample(vol, ms_dev[i], interp, prefiltered=True)
            off, _ = errors(torch, batch[i], want, ms[i])
            errs.append(off)
            assert off <= ATOL, ("batch", order, i, off)
            assert torch.equal(batch[i], kernel(vol, ms_dev[i], order)), \
                "a batched launch differs from a single one"
        buf = torch.full((SIZE,) * 3, float("nan"), device=dev)
        assert kernel(vol, ms_dev[3], order, out=buf) is buf
        assert torch.equal(buf, batch[3]), "write into a preallocated tensor"
        torch.cuda.synchronize()
        emit("parity_batch", order=order, n=len(ms), max_abs_err=max(errs),
             into_buffer="ok", atol=ATOL)
    del vol, batch, buf

    # ---------------------------------------------------- 4. main path
    rng = np.random.default_rng(0)   # bench.py's volume and rotation stream
    vol_np = rng.random((SIZE,) * 3, dtype=np.float64).astype(np.float32)
    center = (SIZE / 2,) * 3
    rots = np.stack([transform_matrix(rotation=tuple(rng.uniform(-180, 180,
                                                                   3)),
                                      rotation_order="sxyz", center=center)
                     for _ in range(N_ROT)]).astype(np.float32)

    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    sv_lin = vt.StaticVolume(vol_np, "linear", device="cuda")
    lin = [sv_lin.affine(m, output="device") for m in rots]
    lin_batch = sv_lin.affine_batch(rots, output="device")
    sv_cub = vt.StaticVolume(vol_np, "filt_bspline", device="cuda")
    cub = [sv_cub.affine(m, output="device") for m in rots]
    cub_batch = sv_cub.affine_batch(rots, output="device")
    host = sv_lin.affine(rots[0])
    into = torch.empty((SIZE,) * 3, device=dev)
    into_ret = sv_cub.affine(rots[1], output=into)
    oneshot = vt.affine(vol_np, rots[0], interpolation="filt_bspline",
                        device="cuda", output="device")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel.launches
    # 16 + 1 batch launch per volume, the host-return call, the write into
    # a preallocated tensor and the one-shot call
    expected = 2 * (N_ROT + 1) + 3
    assert launches == expected, (launches, expected)
    assert vt.last_dispatch()["impl"] == "cuda"

    main_err = {1: 0.0, 3: 0.0}
    for order, sv, outs, batch in ((1, sv_lin, lin, lin_batch),
                                   (3, sv_cub, cub, cub_batch)):
        interp = "linear" if order == 1 else "bspline"
        assert batch.shape == (N_ROT,) + (SIZE,) * 3
        for i, m in enumerate(rots):
            assert outs[i].shape == (SIZE,) * 3
            want = affine_sample(sv.data, torch.from_numpy(m).to(dev), interp,
                                 prefiltered=True)
            off, _ = errors(torch, outs[i], want, m)
            main_err[order] = max(main_err[order], off)
            assert off <= ATOL, ("main", order, i, off)
            assert torch.equal(batch[i], outs[i]), "affine_batch != affine"
    assert isinstance(host, np.ndarray) and host.dtype == np.float32
    assert np.array_equal(host, lin[0].cpu().numpy())
    assert into_ret is into and torch.equal(into, cub[1])
    off_one, _ = errors(torch, oneshot, cub[0], rots[0])
    assert off_one <= ATOL, ("one-shot", off_one)

    # scipy.ndimage oracles on one rotation, on the host in float64
    oracle = {}
    for order, got in ((1, host), (3, cub[0].cpu().numpy())):
        want = ndimage.affine_transform(vol_np.astype(np.float64),
                                        rots[0].astype(np.float64),
                                        order=order, prefilter=True,
                                        mode="constant", cval=0.0)
        off, every = errors(torch, torch.from_numpy(got),
                            torch.from_numpy(want), rots[0])
        oracle[order] = (off, every)
        assert off <= SCIPY_ATOL, ("scipy oracle", order, off)
    emit("main", shape=[SIZE] * 3, rotations=N_ROT, seconds=seconds,
         launches=launches, expected_launches=expected,
         max_abs_err_vs_plain={"linear": main_err[1], "cubic": main_err[3],
                               "one_shot": off_one},
         scipy_oracle={"linear": oracle[1][0], "cubic": oracle[3][0],
                       "linear_all_voxels": oracle[1][1],
                       "cubic_all_voxels": oracle[3][1],
                       "atol": SCIPY_ATOL})
    del lin, cub, lin_batch, cub_batch, oneshot

    # --------------------------------------------------------- 5. times
    coef = {1: sv_lin.data, 3: sv_cub.data}
    rots_dev = torch.from_numpy(rots).to(dev)
    out = torch.empty((SIZE,) * 3, device=dev)
    stack = torch.empty((N_ROT,) + (SIZE,) * 3, device=dev)
    shape = (SIZE,) * 3
    inside = inside_voxels(torch, vt, shape, rots_dev)
    t = {"inside_fraction": sum(inside) / (len(inside) * SIZE ** 3)}
    for order, name in ((1, "linear"), (3, "cubic")):
        state = {"i": 0}

        def one():
            kernel(coef[order], rots_dev[state["i"] % N_ROT], order, out=out)
            state["i"] += 1

        t[f"kernel_{name}_ms"] = time_ms(torch, one, reps=3 * N_ROT)
        t[f"batch_{name}_ms_per_matrix"] = time_ms(
            torch, lambda: kernel(coef[order], rots_dev, order, out=stack),
            reps=3) / N_ROT
        sv = sv_lin if order == 1 else sv_cub

        def api():
            sv.affine(rots[state["i"] % N_ROT], output=out)
            state["i"] += 1

        t[f"static_volume_affine_{name}_ms"] = time_ms(torch, api,
                                                       reps=3 * N_ROT)
        interp = "linear" if order == 1 else "bspline"
        t[f"plain_{name}_ms"] = time_ms(
            torch, lambda: affine_sample(coef[order], rots_dev[0], interp,
                                         prefiltered=True), reps=3, warmup=1)
        t[f"bound_{name}_ms"], t[f"bound_{name}_by"] = bound_ms(
            order, shape, shape, inside, per_launch=1)
        t[f"bound_batch_{name}_ms_per_matrix"], t[
            f"bound_batch_{name}_by"] = bound_ms(order, shape, shape, inside,
                                                 per_launch=N_ROT)
    vol_dev = torch.from_numpy(vol_np).to(dev)
    t["prefilter_mirror_ms"] = time_ms(
        torch, lambda: bspline_prefilter(vol_dev), reps=5)
    t["prefilter_clamp_ms"] = time_ms(
        torch, lambda: bspline_prefilter(vol_dev, "clamp"), reps=2, warmup=1)
    t["one_shot_filt_bspline_ms"] = time_ms(
        torch, lambda: vt.affine(vol_dev, rots[0], "filt_bspline",
                                 device="cuda", output="device"), reps=5)
    # library yardstick: one trilinear grid_sample of the same coordinates
    # (align_corners=True maps -1..1 onto voxel centres 0..n-1); timed
    # only, the grid is built outside the timed region
    coords = vt.ops.affine_coords(shape, rots_dev[0])
    grid = torch.stack([2.0 * coords[2 - a] / (shape[2 - a] - 1) - 1.0
                        for a in range(3)], dim=-1)[None]
    src = coef[1][None, None]
    t["grid_sample_trilinear_ms"] = time_ms(
        torch, lambda: torch.nn.functional.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True), reps=3 * N_ROT)
    emit("times", shape=list(shape), method="CUDA events, back-to-back "
         "launches after warm-up; the 62.5 MB volume exceeds the 50 MB L2",
         **t)

    kernels = [{
        "name": K.NAME, "route": "cuda", "source": K.SOURCE,
        "replaces": K.REPLACES, "launches": launches,
        "max_abs_err": max(worst[1], worst[3], main_err[1], main_err[3]),
        "ms": t["kernel_linear_ms"], "plain_ms": t["plain_linear_ms"],
        "bound_ms": t["bound_linear_ms"], "bound_by": t["bound_linear_by"],
        "library_ms": t["grid_sample_trilinear_ms"],
        "shape": list(shape), "max_abs_err_all_voxels": worst_all,
        "batch_ms_per_matrix": t["batch_linear_ms_per_matrix"],
        "batch_bound_ms_per_matrix": t["bound_batch_linear_ms_per_matrix"],
        "cubic": {"ms": t["kernel_cubic_ms"], "plain_ms": t["plain_cubic_ms"],
                  "bound_ms": t["bound_cubic_ms"],
                  "bound_by": t["bound_cubic_by"], "library_ms": None,
                  "batch_ms_per_matrix": t["batch_cubic_ms_per_matrix"],
                  "batch_bound_ms_per_matrix":
                      t["bound_batch_cubic_ms_per_matrix"],
                  "max_abs_err": max(worst[3], main_err[3])},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

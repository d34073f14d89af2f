#!/usr/bin/env python3
"""What the designs of template matching's sigma kernel buy, on one GPU, at
widths of both: for each width X, the two complex128 moments of a (Z, 512,
X) volume (Z * X = 256 * 512, tm512's voxels), inverted along z and y and
laid out as ``TemplateMatcher`` keeps them, into the map.

Builds variants of ``voltools_tpu_torch/csrc/match_sigma.cu`` from edited
copies of the source (in a temporary directory; the repository is not
touched):

* ``committed`` -- the source as it is: a power of two from 128 to 2048
  through the register design, any other width through the shared-memory
  design;
* ``shared``    -- every width through the shared-memory design;
* ``stockham<r>_blocks<b>`` -- the shared-memory design with Stockham's
  passes of radix r at most, r points a thread (L / r threads a row) and
  at least b CTAs an SM, which caps a thread's registers (committed: 8
  and 2; ``stockham16_blocks1`` is the design's first form);
* ``bluestein<r>_blocks<b>`` -- the same for Bluestein's passes
  (committed: 16 and 1).

Each variant's map (both entries) is held to the plain version
(``plain_match_sigma``, torch's C2R along x and the plain passes: the
former tail of ``TemplateMatcher._local_inv`` after the inverse along y)
first, then each is timed with CUDA events over 10 calls of both entries,
in turns (the list, then the list reversed), beside the bound (the
moments read once and the map written once, then the map read and written
once) and the plain version's time.  Run from the repository root::

    python3 tools/match_sigma_variants.py [X ...]

(default X: 128 512 1024 2048 180 255 960 1000 194 2042).  It prints the card's
name and power limit, one JSON line of nvcc's registers and spill stores
of each variant's entries, one of the largest difference from the plain
version over each voxel's plain value, then one JSON line of the median
ms of each variant and width with its turns.
"""

import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

HEIGHT = 512
VOXELS = 256 * 512 * 512
REPS = 10
TURNS = 2
WIDTHS = (128, 512, 1024, 2048, 180, 255, 960, 1000, 194, 2042)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM's HBM3
FLOOR = 1e-12

SHARED = ("constexpr int kMaxLog2 = 10;", "constexpr int kMaxLog2 = 5;")


def knobs(path, radix, blocks, committed):
    """The edits that give ``path``'s (``Stockham`` or ``Bluestein``)
    passes ``radix`` and ``blocks`` in place of ``committed``'s."""
    return [(f"constexpr int k{path}Radix = {committed[0]};",
             f"constexpr int k{path}Radix = {radix};"),
            (f"constexpr int k{path}Blocks = {committed[1]};",
             f"constexpr int k{path}Blocks = {blocks};")]


VARIANTS = {
    "committed": [],
    "shared": [SHARED],
    "stockham16_blocks1": [SHARED] + knobs("Stockham", 16, 1, (8, 2)),
    "stockham4_blocks3": [SHARED] + knobs("Stockham", 4, 3, (8, 2)),
    "bluestein8_blocks2": knobs("Bluestein", 8, 2, (16, 1)),
}


def edited(source, edits):
    for old, new in edits:
        if old not in source:
            raise SystemExit(f"match_sigma_variants: the source no longer "
                             f"holds {old.splitlines()[0]!r}")
        source = source.replace(old, new)
    return source


def build(name, source, workdir):
    """(the variant's two C entries, nvcc's (registers, spill stores) of
    its kernels)."""
    from voltools_tpu_torch.kernels import _build, match_sigma as MS
    path = os.path.join(workdir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(source)
    lib = os.path.join(workdir, f"lib{name}.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.flags(), "-I",
                           str(_build.CSRC_DIR), "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    log = proc.stdout + proc.stderr
    cdll = ctypes.CDLL(lib)
    launch, finish = cdll.match_sigma_launch, cdll.match_sigma_finish_launch
    launch.argtypes, launch.restype = MS.ARGTYPES, ctypes.c_int
    finish.argtypes, finish.restype = MS.FINISH_ARGTYPES, ctypes.c_int
    # every kernel instance: the register design's of each H, the
    # shared-memory design's of each (radix, CTAs an SM)
    usage = {}
    for entry in sorted(set(re.findall(
            r"Compiling entry function '(_Z\w*match_sigma\w*)'", log))):
        usage[entry] = _build.ptxas_usage(log, entry)
    return (launch, finish), usage


def applies(name, design):
    """Whether variant ``name`` differs from the committed source at a
    width of ``design``."""
    if name in ("committed", "shared"):
        return name == "committed" or design == "registers"
    if name.startswith("bluestein"):
        return design == "bluestein"
    return design != "bluestein"


def moments(torch, shape, dev, seed):
    """mean' random and mean_sq' such that w = N n mean_sq' - mean'^2 is a
    random positive map, as spectra along y and x in the matcher's layout
    (the inverse along y still to take), and n."""
    from voltools_tpu_torch.models.matching import _spectral_layout
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 4321.5
    scale = math.prod(shape) * n
    mean = torch.randn(shape, dtype=torch.float64, generator=gen,
                       device=dev) * (0.3 * scale)
    w = (torch.rand(shape, dtype=torch.float64, generator=gen, device=dev)
         * 1.5 + 0.5) * scale ** 2
    mean_sq = (w + mean * mean) / scale
    del w
    out = []
    for real in (mean, mean_sq):
        ft = torch.fft.rfftn(real, dim=(1, 2), norm="forward")
        out.append(_spectral_layout(shape, torch.complex128, dev).copy_(ft))
        del ft
    return out[0], out[1], torch.tensor(n, dtype=torch.float32, device=dev)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("match_sigma_variants: no CUDA device", file=sys.stderr)
        return 1
    from voltools_tpu_torch.kernels import match_sigma as MS
    from voltools_tpu_torch.kernels import match_zpass as ZP
    widths = [int(a) for a in argv] or list(WIDTHS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print("card:", card, flush=True)
    with open(os.path.join(HERE, MS.SOURCE)) as f:
        source = f.read()
    workdir = tempfile.mkdtemp()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = {name: pool.submit(build, name, edited(source, edits),
                                   workdir)
                 for name, edits in VARIANTS.items()}
    entries = {name: f.result()[0] for name, f in built.items()}
    usage = {name: f.result()[1] for name, f in built.items()}
    print(json.dumps({"registers_spills": usage}), flush=True)
    dev = torch.device("cuda")

    def call(fns, case):
        mean, mean_sq, n, out, largest, tables = case
        launch, finish = fns
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(mean.data_ptr(), mean_sq.data_ptr(), *mean.stride(),
                      *out.shape, n.data_ptr(), out.data_ptr(),
                      largest.data_ptr(),
                      None if tables is None else tables.data_ptr(), stream)
        code = code or finish(out.data_ptr(), out.numel(),
                              largest.data_ptr(), FLOOR, stream)
        if code:
            raise RuntimeError(f"launch failed ({code})")

    def ms(fn, *args, reps=REPS):
        for _ in range(2):
            fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    errors, times, bounds, plain, designs = {}, {}, {}, {}, {}
    for width in widths:
        shape = (max(1, VOXELS // (HEIGHT * width)), HEIGHT, width)
        key = f"{width}"
        designs[key] = MS.design(width)
        mean, mean_sq, n = moments(torch, shape, dev, width)
        mean = torch.fft.ifft(mean, dim=1, norm="forward")
        mean_sq = torch.fft.ifft(mean_sq, dim=1, norm="forward")
        tables = (ZP.chirp_tables(MS.points(width), torch.complex128, dev)
                  if designs[key] == "bluestein" else None)
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        largest = torch.empty(1, dtype=torch.int32, device=dev)
        case = (mean, mean_sq, n, out, largest, tables)
        want = MS.plain_match_sigma(mean, mean_sq, n, width, FLOOR)
        names = [v for v in entries if applies(v, designs[key])]
        for name in names:
            out.fill_(float("nan"))
            call(entries[name], case)
            torch.cuda.synchronize()
            errors[f"{name} {key}"] = float(
                ((out - want).abs() / want).max())
        del want
        for turn in range(TURNS):
            for name in (names if turn % 2 == 0 else names[::-1]):
                times.setdefault(f"{name} {key}", []).append(
                    ms(call, entries[name], case))
        plain[key] = ms(MS.plain_match_sigma, mean, mean_sq, n, width,
                        FLOOR, reps=3)
        voxels = math.prod(shape)
        read = 2 * mean.numel() * mean.element_size()
        bounds[key] = (read + 3 * voxels * 4) / HBM_BYTES_PER_S * 1e3
        del mean, mean_sq, out, case, tables
        torch.cuda.empty_cache()
    print(json.dumps({"max_rel_err": errors}), flush=True)
    print(json.dumps({"card": card, "designs": designs, "bound_ms": bounds,
                      "plain_ms": plain,
                      "median_ms": {k: statistics.median(v)
                                    for k, v in times.items()},
                      "turns_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

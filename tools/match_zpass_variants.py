#!/usr/bin/env python3
"""What the designs of template matching's spectral pass along z buy, on
one GPU, at tm512's width: 48 planes of a (N, 512, 512) tomogram's half
spectrum, (N, 512, 257) spectra laid out as ``TemplateMatcher`` keeps
them, for depths N of both designs.

Builds variants of ``voltools_tpu_torch/csrc/match_zpass.cu`` from edited
copies of the source (in a temporary directory; the repository is not
touched):

* ``committed`` -- the source as it is: a power of two from 64 to 1024
  through the register design, any other N through the shared-memory
  design;
* ``shared``    -- every N through the shared-memory design.

An N with a prime factor above 7 is timed both ways, whatever
``MAX_DIRECT`` chooses: ``direct`` (the prime's paired direct sums) and
``bluestein`` (Bluestein's convolution).  Each variant's results
(complex64 with one spectrum, complex128 with two) are held to the plain
version (``plain_match_zpass``) first, then each is timed with CUDA
events over 10 launches, in turns (the list, then the list reversed),
beside the bound (the planes and the spectra read once, the results
written once) and the plain version's time.  Run from the repository
root::

    python3 tools/match_zpass_variants.py [N ...]

(default N: 256 512 1024 180 300 62 142 194 254 1021).  It prints the
card's name and power limit, one JSON line of nvcc's registers and spill
stores of each variant's entries, one of the largest difference from the
plain version, then one JSON line of the median ms of each variant, N and
dtype with its turns.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

HEIGHT, WIDTH = 512, 512
BOX = 48
REPS = 10
TURNS = 2
DEPTHS = (256, 512, 1024, 180, 300, 62, 142, 194, 254, 1021)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM's HBM3

REGISTER_RANGE = "constexpr int kMaxLog2 = 10;"
VARIANTS = {
    "committed": [],
    "shared": [(REGISTER_RANGE, "constexpr int kMaxLog2 = 5;")],
}
ENTRIES = {"registers f": "match_zpass_kernelIfLi{n}ELi1E",
           "registers d": "match_zpass_kernelIdLi{n}ELi2E",
           "shared f": "match_zpass_shared_kernelIfLi1E",
           "shared d": "match_zpass_shared_kernelIdLi2E"}


def edited(source, edits):
    for old, new in edits:
        if old not in source:
            raise SystemExit(f"match_zpass_variants: the source no longer "
                             f"holds {old.splitlines()[0]!r}")
        source = source.replace(old, new)
    return source


def build(name, source, workdir):
    """(the C entry of the variant, nvcc's (registers, spill stores) of
    its entries)."""
    from voltools_tpu_torch.kernels import _build, match_zpass as ZP
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
    fn = ctypes.CDLL(lib).match_zpass_launch
    fn.argtypes, fn.restype = ZP.ARGTYPES, ctypes.c_int
    usage = {}
    for key, entry in ENTRIES.items():
        for n in ((256, 512, 1024) if "{n}" in entry else (None,)):
            found = _build.ptxas_usage(log, entry.format(n=n))
            if found:
                usage[key if n is None else f"{key} {n}"] = found
    return fn, usage


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("match_zpass_variants: no CUDA device", file=sys.stderr)
        return 1
    from voltools_tpu_torch.kernels import match_zpass as ZP
    from voltools_tpu_torch.models.matching import _spectral_layout
    depths = [int(a) for a in argv] or list(DEPTHS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print("card:", card, flush=True)
    with open(os.path.join(HERE, ZP.SOURCE)) as f:
        source = f.read()
    workdir = tempfile.mkdtemp()
    entries, usage = {}, {}
    for name, edits in VARIANTS.items():
        entries[name], usage[name] = build(name, edited(source, edits),
                                           workdir)
    print(json.dumps({"registers_spills": usage}), flush=True)
    dev = torch.device("cuda")
    half = WIDTH // 2 + 1

    def call(fn, case, tables=None):
        planes, spectra, outs, _ = case
        wide = len(spectra) == 2
        code = fn(planes.data_ptr(), *planes.stride(), spectra[0].data_ptr(),
                  spectra[1].data_ptr() if wide else None,
                  outs[0].data_ptr(), outs[1].data_ptr() if wide else None,
                  *spectra[0].stride(), spectra[0].shape[0], BOX, BOX // 2,
                  HEIGHT, half,
                  None if tables is None else tables.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
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

    errors, times, bounds, plain = {}, {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(5)
    for n in depths:
        for dtype in (torch.complex64, torch.complex128):
            key = f"{n} {str(dtype).split('.')[-1]}"
            planes = torch.randn((BOX, half, HEIGHT), dtype=dtype,
                                 generator=gen, device=dev).permute(0, 2, 1)
            spectra = tuple(_spectral_layout((n, HEIGHT, WIDTH), dtype,
                                             dev).copy_(
                torch.randn((n, HEIGHT, half), dtype=dtype, generator=gen,
                            device=dev))
                for _ in range(ZP.SPECTRA[dtype]))
            outs = tuple(torch.empty_like(s) for s in spectra)
            want = tuple(torch.empty_like(s) for s in spectra)
            ZP.plain_match_zpass(planes, spectra, want, BOX // 2)
            case = (planes, spectra, outs, want)
            runs = {name: (fn, None) for name, fn in entries.items()}
            if any(r % 2 and r > 7 for r in ZP.radices(n)):
                # Bluestein's tables whatever MAX_DIRECT chooses for n
                direct, ZP.MAX_DIRECT = ZP.MAX_DIRECT, 7
                try:
                    tables = ZP.chirp_tables(n, dtype, dev)
                finally:
                    ZP.MAX_DIRECT = direct
                runs = {"direct": (entries["committed"], None),
                        "bluestein": (entries["committed"], tables)}
            for name, (fn, tables) in runs.items():
                for out in outs:
                    out.fill_(float("nan"))
                call(fn, case, tables)
                torch.cuda.synchronize()
                errors[f"{name} {key}"] = max(
                    float((o - w).abs().max() / w.abs().max())
                    for o, w in zip(outs, want))
            names = list(runs)
            for turn in range(TURNS):
                for name in (names if turn % 2 == 0 else names[::-1]):
                    fn, tables = runs[name]
                    times.setdefault(f"{name} {key}", []).append(
                        ms(call, fn, case, tables))
            plain[key] = ms(ZP.plain_match_zpass, planes, spectra, want,
                            BOX // 2, reps=3)
            bounds[key] = planes.element_size() * (
                planes.numel() + 2 * len(spectra) * spectra[0].numel()
            ) / HBM_BYTES_PER_S * 1e3
            del planes, spectra, outs, want, case
            torch.cuda.empty_cache()
    print(json.dumps({"max_rel_err": errors}), flush=True)
    print(json.dumps({"card": card, "bound_ms": bounds, "plain_ms": plain,
                      "median_ms": {k: statistics.median(v)
                                    for k, v in times.items()},
                      "turns_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

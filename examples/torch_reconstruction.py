"""Tomographic reconstruction through the PyTorch port
(``voltools_tpu_torch``): the counterpart of
``examples/reconstruction.py``.

Projects a phantom through a +-60 degree tilt series (the missing wedge of
cryo-ET), then inverts it:
  1. ``TiltSeriesProjector`` renders the series (the planner's resampling
     kernels, then a sum on the device),
  2. ``wbp_reconstruct`` -- weighted back-projection (the ramp filter,
     then one launch of the back-projection kernel),
  3. ``sirt_reconstruct`` -- 30 SIRT iterations (a forward sweep and a
     back-projection each).

Prints the interior correlations of both reconstructions with the
phantom and writes ``torch_reconstruction_example.png`` with central
slices of all four.

    python3 examples/torch_reconstruction.py                 # on the card
    python3 examples/torch_reconstruction.py --device cpu --size 32
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from voltools_tpu_torch.models import (TiltSeriesProjector,  # noqa: E402
                                       sirt_reconstruct, wbp_reconstruct)
from voltools_tpu_torch.utils import resolve_device  # noqa: E402

ANGLES = np.arange(-60.0, 61.0, 3.0)   # 41 tilts
TILT_AXIS = 0
CROP = 8                                # voxels left out of each face


def make_volume(n=64):
    rng = np.random.default_rng(0)
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(10):
        c = rng.integers(n // 4, 3 * n // 4, 3)
        r = rng.integers(3, 8)
        z, y, x = np.ogrid[:n, :n, :n]
        vol[(z - c[0]) ** 2 + (y - c[1]) ** 2
            + (x - c[2]) ** 2 < r * r] += 1.0
    return vol


def _clock(dev):
    """The host clock, read once the device's queue has drained: without
    the wait a clock on the card times the enqueue only."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _device_name(dev):
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu (plain torch)"


def _pipeline(vol, device, dev, iterations):
    """Project, WBP and SIRT, as numpy, with each step's ms."""
    shape = vol.shape
    proj = TiltSeriesProjector(vol, interpolation="linear", device=device)
    ms = proj.tilt_matrices(ANGLES, tilt_axis=TILT_AXIS)
    t0 = _clock(dev)
    tilts = proj.project(ANGLES, tilt_axis=TILT_AXIS)
    t1 = _clock(dev)
    rec_wbp = wbp_reconstruct(tilts, ms, shape, device=device)
    t2 = _clock(dev)
    rec_sirt = sirt_reconstruct(tilts, ms, shape, iterations=iterations,
                                device=device)
    t3 = _clock(dev)
    times = {"project": (t1 - t0) * 1e3, "wbp": (t2 - t1) * 1e3,
             "sirt": (t3 - t2) * 1e3}
    return ms, tilts, rec_wbp, rec_sirt, times


def main(device="cuda", size=64, iterations=30,
         figure="torch_reconstruction_example.png"):
    """Run the example; returns the arrays and numbers it prints.

    ``device='cuda'`` (the default) raises where there is no card;
    ``'cpu'`` runs the port's plain torch versions.  ``figure`` is the PNG
    to write, or None."""
    dev = resolve_device(device)
    vol = make_volume(size)
    # on the card the first pass builds the kernels with nvcc and plans
    # cuFFT; only the last pass is timed
    passes = 2 if dev.type == "cuda" else 1
    for _ in range(passes):
        ms, tilts, rec_wbp, rec_sirt, times = _pipeline(vol, device, dev,
                                                        iterations)

    sl = np.s_[CROP:-CROP, CROP:-CROP, CROP:-CROP]
    corr = {}
    for name, rec in (("wbp", rec_wbp), ("sirt", rec_sirt)):
        corr[name] = float(np.corrcoef(vol[sl].ravel(),
                                       rec[sl].ravel())[0, 1])
        print(f"{name.upper():>5} interior correlation: {corr[name]:.4f}")
    card = _device_name(dev)
    print(f"project {times['project']:8.2f} ms "
          f"({times['project'] / len(ANGLES):.3f} a tilt, copied to the "
          f"host)  |  WBP {times['wbp']:8.2f} ms  |  SIRT({iterations}) "
          f"{times['sirt']:8.2f} ms ({times['sirt'] / iterations:.3f} an "
          f"iteration)  on {card}")
    result = dict(passes=passes, volume=vol, angles=ANGLES, matrices=ms,
                  projections=tilts, wbp=rec_wbp, sirt=rec_sirt,
                  iterations=iterations, interior_correlation=corr,
                  ms=times, card=card)
    if figure is None:
        return result
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping figure")
        return result
    mid = vol.shape[0] // 2
    fig, axes = plt.subplots(1, 4, figsize=(13, 3.4))
    for ax, (title, img) in zip(axes, [
            ("phantom", vol[mid]),
            (f"projection 0° ({len(ANGLES)} tilts)",
             tilts[len(ANGLES) // 2]),
            ("WBP", rec_wbp[mid]),
            (f"SIRT ({iterations} it)", rec_sirt[mid])]):
        ax.imshow(img, cmap="gray")
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(figure, dpi=120)
    plt.close(fig)
    print(f"wrote {figure}")
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", type=int, default=64)
    args = parser.parse_args()
    main(args.device, args.size)

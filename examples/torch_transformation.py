"""One transform on the CPU (scipy) and on the card, through the PyTorch
port (``voltools_tpu_torch``): the counterpart of
``examples/transformation.py``.

Builds a test volume, applies the same centre rotation + translation with
``scipy.ndimage`` (the port's ``cpu_backend='scipy'``) and on the device
(the B-spline prefilter, then the planner's CUDA kernel), prints their
agreement and times, and (when matplotlib is present) writes a
side-by-side middle-slice figure.

    python3 examples/torch_transformation.py                  # on the card
    python3 examples/torch_transformation.py --device cpu --size 32
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
import voltools_tpu_torch as vt  # noqa: E402
from voltools_tpu_torch.utils import (resolve_device,  # noqa: E402
                                      transform_matrix)

ROTATION = (45.0, 0.0, 0.0)
ROTATION_ORDER = "rzxz"
TRANSLATION = (0.0, 4.0, -2.0)
INTERPOLATION = "filt_bspline"


def make_volume(n=64):
    z, y, x = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
    ball = (z ** 2 + y ** 2 + x ** 2 < 0.6).astype(np.float32)
    stripes = (np.sin(8 * np.pi * x) > 0).astype(np.float32)
    return ball * (1 + stripes)


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


def main(device="cuda", size=64, figure="torch_transformation_example.png"):
    """Run the example; returns the arrays and numbers it prints.

    ``device='cuda'`` (the default) raises where there is no card;
    ``'cpu'`` runs the port's plain torch versions.  ``figure`` is the PNG
    to write, or None."""
    dev = resolve_device(device)
    volume = make_volume(size)
    center = np.divide(np.subtract(volume.shape, 1), 2, dtype=np.float32)
    # the matrix vt.transform composes for these arguments
    m = transform_matrix(rotation=ROTATION, rotation_order=ROTATION_ORDER,
                         translation=TRANSLATION, center=center)

    # on the card the first pass builds the kernel with nvcc (and the
    # first scipy call imports scipy.ndimage); only the last pass is timed
    passes = 2 if dev.type == "cuda" else 1
    for _ in range(passes):
        t0 = time.perf_counter()
        cpu = vt.affine(volume, m, INTERPOLATION, device="cpu",
                        cpu_backend="scipy")
        scipy_ms = (time.perf_counter() - t0) * 1e3
        t0 = _clock(dev)
        acc = vt.transform(volume, rotation=ROTATION,
                           rotation_order=ROTATION_ORDER,
                           translation=TRANSLATION,
                           interpolation=INTERPOLATION, device=device)
        device_ms = (_clock(dev) - t0) * 1e3

    diff = float(np.abs(cpu - acc).max())
    name = _device_name(dev)
    print(f"volume {volume.shape}, {INTERPOLATION}, rotation {ROTATION} "
          f"{ROTATION_ORDER}, translation {TRANSLATION}")
    print(f"max |scipy - port on {device}| = {diff:.2e}")
    print(f"scipy {scipy_ms:8.2f} ms (host)  |  port {device_ms:8.2f} ms on "
          f"{name} (upload, prefilter, resample, copy back)")
    result = dict(passes=passes, volume=volume, matrix=m, scipy=cpu,
                  device=acc, max_abs_diff=diff, scipy_ms=scipy_ms,
                  device_ms=device_ms, card=name)
    if figure is None:
        return result
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping figure")
        return result

    mid = volume.shape[0] // 2
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    panels = [(volume, "input"), (cpu, "cpu (scipy)"),
              (acc, f"voltools_tpu_torch, {device}")]
    for ax, (img, title) in zip(axes, panels):
        ax.imshow(img[mid], cmap="gray")
        ax.set_title(title)
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

"""Tilt-series rotate+project pipeline through the PyTorch port
(``voltools_tpu_torch``): the counterpart of ``examples/projections.py``.

Shows the three API levels:
  1. one-shot ``vt.transform`` per tilt, each rotated volume copied back to
     the host and summed there (what the JAX example loops),
  2. resident ``StaticVolume`` per tilt (matrix-only upload; each rotated
     volume is written into one tensor on the device and summed there),
  3. ``TiltSeriesProjector`` -- the whole series in launches of many tilts
     each, summed on the device.

    python3 examples/torch_projections.py                    # on the card
    python3 examples/torch_projections.py --device cpu --size 24
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
from voltools_tpu_torch.models import TiltSeriesProjector  # noqa: E402
from voltools_tpu_torch.utils import resolve_device  # noqa: E402

ANGLES = np.arange(-60.0, 61.0, 3.0)   # 41 tilts
ROTATION_ORDER = "sxyz"
TILT_AXIS = 1


def make_volume(n=96):
    rng = np.random.default_rng(0)
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(12):  # a few random dense blobs
        c = rng.integers(n // 4, 3 * n // 4, 3)
        r = rng.integers(4, 10)
        z, y, x = np.ogrid[:n, :n, :n]
        vol[(z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2 < r * r] += 1.0
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


def _levels(volume, device, dev):
    """The three levels' projections and each level's ms."""
    center = np.divide(np.subtract(volume.shape, 1), 2)
    rotations = [(0.0, a, 0.0) for a in ANGLES]

    # 1) one-shot API: each call uploads the volume and returns the whole
    # rotated volume to the host, which sums it
    t0 = _clock(dev)
    oneshot = np.stack([
        vt.transform(volume, rotation=r, rotation_order=ROTATION_ORDER,
                     center=center, device=device).sum(axis=0)
        for r in rotations])
    t1 = _clock(dev)

    # 2) resident volume: one matrix up per tilt, each rotation written
    # into one preallocated tensor on the device and summed there
    sv = vt.StaticVolume(volume, interpolation="linear", device=device)
    buf = torch.empty(volume.shape, dtype=torch.float32, device=dev)
    t2 = _clock(dev)
    resident = torch.stack([
        sv.transform(rotation=r, rotation_order=ROTATION_ORDER,
                     center=center, output=buf).sum(dim=0)
        for r in rotations]).cpu().numpy()
    t3 = _clock(dev)

    # 3) fused projector
    proj = TiltSeriesProjector(volume, device=device,
                               rotation_order=ROTATION_ORDER)
    t4 = _clock(dev)
    fused = proj.project(ANGLES, tilt_axis=TILT_AXIS)
    t5 = _clock(dev)
    ms = {"one_shot": (t1 - t0) * 1e3, "static_volume": (t3 - t2) * 1e3,
          "projector": (t5 - t4) * 1e3}
    return oneshot, resident, fused, proj.tilt_matrices(ANGLES, TILT_AXIS), ms


def main(device="cuda", size=96, figure="torch_projections_example.png"):
    """Run the example; returns the arrays and numbers it prints.

    ``device='cuda'`` (the default) raises where there is no card;
    ``'cpu'`` runs the port's plain torch versions.  ``figure`` is the PNG
    to write, or None."""
    dev = resolve_device(device)
    volume = make_volume(size)
    # on the card the first pass builds the kernels with nvcc; only the
    # last pass is timed
    passes = 2 if dev.type == "cuda" else 1
    for _ in range(passes):
        oneshot, resident, fused, matrices, ms = _levels(volume, device, dev)

    name = _device_name(dev)
    n = len(ANGLES)
    diff_resident = float(np.abs(oneshot - resident).max())
    diff_fused = float(np.abs(oneshot - fused).max())
    print(f"tilts: {n}  volume: {volume.shape}  on {name}")
    print(f"one-shot transform loop : {ms['one_shot']:9.2f} ms "
          f"({ms['one_shot'] / n:.3f} a tilt; each rotated volume is "
          f"copied to the host and summed there)")
    print(f"StaticVolume loop       : {ms['static_volume']:9.2f} ms "
          f"({ms['static_volume'] / n:.3f} a tilt)")
    print(f"TiltSeriesProjector     : {ms['projector']:9.2f} ms "
          f"({ms['projector'] / n:.3f} a tilt)")
    print("agreement one-shot vs resident:", diff_resident)
    print("agreement one-shot vs fused   :", diff_fused)
    result = dict(passes=passes, volume=volume, angles=ANGLES,
                  matrices=matrices, one_shot=oneshot,
                  static_volume=resident, projector=fused,
                  max_abs_diff={"one_shot_vs_static_volume": diff_resident,
                                "one_shot_vs_projector": diff_fused},
                  ms=ms, card=name)
    if figure is None:
        return result
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping figure")
        return result
    fig, axes = plt.subplots(1, 5, figsize=(16, 3.5))
    for ax, i in zip(axes, np.linspace(0, n - 1, 5).astype(int)):
        ax.imshow(fused[i], cmap="gray")
        ax.set_title(f"{ANGLES[i]:+.0f} deg")
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(figure, dpi=120)
    plt.close(fig)
    print(f"wrote {figure}")
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", type=int, default=96)
    args = parser.parse_args()
    main(args.device, args.size)

"""Volume registration through the PyTorch port (``voltools_tpu_torch``):
the counterpart of ``examples/registration.py``.

Recovers an unknown rigid misalignment:
  1. misalign a blob phantom by a hidden rigid transform (about 6 degrees
     and a shift of a few voxels, applied by the port's resampling
     kernel), rescale its intensities and add noise,
  2. ``phase_cross_correlation`` -- the FFT global shift estimate
     (matrix-multiply upsampled DFT for the subvoxel part),
  3. ``register(model='rigid', loss='ncc')`` -- Adam through the
     differentiable torch sampler, on a two-level pyramid,
  4. apply the recovered matrix through the port's resampling kernel.

Writes ``torch_registration_example.png``: central slices of reference,
moving, registered, and the error maps before and after.

    python3 examples/torch_registration.py                   # on the card
    python3 examples/torch_registration.py --device cpu --size 32
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import voltools_tpu_torch as vt  # noqa: E402
from voltools_tpu_torch.models import (phase_cross_correlation,  # noqa: E402
                                       register)
from voltools_tpu_torch.utils import (resolve_device,  # noqa: E402
                                      rodrigues_matrix)

# the hidden ground truth: about 6 degrees and a shift of a few voxels
W_TRUE = (0.05, -0.07, 0.06)    # axis-angle, radians
T_TRUE = (3.4, -2.2, 1.8)       # content shift, voxels
UPSAMPLE = 10
CROP = 6                        # voxels left out of each face for the misfit


def make_volume(n=64, seed=0):
    rng = np.random.default_rng(seed)
    vol = np.zeros((n, n, n), np.float32)
    z, y, x = np.ogrid[:n, :n, :n]
    for _ in range(14):
        c = rng.integers(n // 4, 3 * n // 4, 3)
        r = rng.integers(3, 9)
        vol[(z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2 < r * r] += 1.0
    return gaussian_filter(vol, 1.2).astype(np.float32)


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


def _register(ref, moving, device, dev, steps, levels):
    """The phase correlation, ``register`` and the applied result, with
    the ms of the first two."""
    t0 = _clock(dev)
    shift0 = phase_cross_correlation(ref, moving, upsample=UPSAMPLE,
                                     device=device).cpu().numpy()
    t1 = _clock(dev)
    res = register(moving, ref, model="rigid", loss="ncc", steps=steps,
                   lr=0.02, levels=levels, device=device)
    t2 = _clock(dev)
    registered = res.apply(moving, device=device)
    return shift0, res, registered, {"phase_correlation": (t1 - t0) * 1e3,
                                     "register": (t2 - t1) * 1e3}


def main(device="cuda", size=64, steps=300, levels=2,
         figure="torch_registration_example.png"):
    """Run the example; returns the arrays and numbers it prints.

    ``device='cuda'`` (the default) raises where there is no card;
    ``'cpu'`` runs the port's plain torch versions.  ``figure`` is the PNG
    to write, or None."""
    dev = resolve_device(device)
    ref = make_volume(size)
    center = tuple((s - 1) / 2 for s in ref.shape)

    w_true = np.asarray(W_TRUE, np.float32)
    t_true = np.asarray(T_TRUE, np.float32)
    m_true = rodrigues_matrix(torch.from_numpy(w_true), center).numpy()
    m_true[:3, 3] -= t_true
    misaligned = vt.affine(ref, m_true, "linear", device=device)
    rng = np.random.default_rng(1)
    moving = 1.7 * misaligned + 0.2 + rng.normal(0, 0.01, ref.shape)
    moving = moving.astype(np.float32)

    # on the card the first pass builds the kernel with nvcc and plans
    # cuFFT; only the last pass is timed
    passes = 2 if dev.type == "cuda" else 1
    for _ in range(passes):
        shift0, res, registered, times = _register(ref, moving, device, dev,
                                                   steps, levels)

    # register(moving, ref) recovers the INVERSE of m_true (the matrix that
    # pulls `moving` back onto `ref`); the expected axis-angle is -w_true
    w_expect = -w_true
    r_inv = m_true[:3, :3].T
    c_arr = np.asarray(center, np.float32)
    # solve c - R'c - R't' = inv(m_true)[:3,3] for t'
    m_inv = np.linalg.inv(m_true)
    t_expect = np.linalg.solve(r_inv, c_arr - r_inv @ c_arr - m_inv[:3, 3])
    w_err = float(np.degrees(np.linalg.norm(res.params["w"] - w_expect)))
    t_err = float(np.abs(res.params["t"] - t_expect).max())
    card = _device_name(dev)
    print(f"phase-correlation shift: {shift0.round(2)}  "
          f"({times['phase_correlation']:.2f} ms)")
    print(f"recovered rotation (rad): {res.params['w'].round(4)}  "
          f"expected (inverse): {w_expect}")
    print(f"recovered shift   (vox): {res.params['t'].round(3)}  "
          f"expected: {t_expect.round(3)}")
    print(f"rotation error: {w_err:.3f} deg   shift error: {t_err:.4f} vox"
          f"   register: {times['register']:.1f} ms "
          f"({len(res.loss_history)} steps, {levels} levels) on {card}")

    sl = np.s_[CROP:-CROP, CROP:-CROP, CROP:-CROP]

    # compare on normalised intensities (the moving volume was rescaled)
    def norm(v):
        v = v[sl]
        return (v - v.mean()) / v.std()

    misfit = {"before": float(np.abs(norm(moving) - norm(ref)).mean()),
              "after": float(np.abs(norm(registered) - norm(ref)).mean())}
    print(f"normalised L1 misfit: before {misfit['before']:.3f} -> "
          f"after {misfit['after']:.3f}")
    result = dict(passes=passes, reference=ref, misaligned=misaligned,
                  moving=moving, registered=registered, m_true=m_true,
                  phase_correlation_shift=shift0,
                  matrix=res.matrix, w=res.params["w"], t=res.params["t"],
                  loss_history=res.loss_history, w_expect=w_expect,
                  t_expect=t_expect, rotation_error_deg=w_err,
                  translation_error_vox=t_err, misfit=misfit, ms=times,
                  card=card)
    if figure is None:
        return result
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping PNG")
        return result
    k = ref.shape[0] // 2
    panels = [("reference", ref[k]), ("moving", moving[k]),
              ("registered", registered[k]),
              ("|diff| before", np.abs(norm(moving) - norm(ref))[k - CROP]),
              ("|diff| after",
               np.abs(norm(registered) - norm(ref))[k - CROP])]
    fig, axes = plt.subplots(1, len(panels), figsize=(3.2 * len(panels), 3.4))
    for ax, (title, img) in zip(axes, panels):
        ax.imshow(img, cmap="gray")
        ax.set_title(title, fontsize=10)
        ax.axis("off")
    fig.suptitle("voltools_tpu_torch rigid registration "
                 f"(rotation error {w_err:.3f}°)", fontsize=12)
    fig.tight_layout()
    fig.savefig(figure, dpi=110)
    plt.close(fig)
    print(f"wrote {figure}")
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", type=int, default=64)
    args = parser.parse_args()
    main(args.device, args.size)

"""The plain reference that decides ``correct``.

Plain PyTorch in float64 (TF32 off), written from the functions' published
semantics: scipy.ndimage's order-1 and prefiltered order-3
``affine_transform`` in ``'constant'`` mode, the cryo-ET forward model
(rotate, sum along the beam) and its back-projection, WBP and SIRT.  It
imports nothing of ``voltools_tpu_torch`` or of the JAX package and takes
nothing that the program made: it is handed the harness's inputs (volume,
float32 matrices, projections) and works out the rest again.

``dtype`` / ``q`` select the control: the same arithmetic computed in
bfloat16, the nearest precision below the float32 that the
configurations state.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rounder(dtype):
    """The rounding each stored result takes: none for float64, else a
    round trip through ``dtype``."""
    if dtype == torch.float64:
        return lambda t: t
    return lambda t: t.to(dtype).to(torch.float64)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float64."""
    want = want.to(torch.float64)
    diff = (got.to(torch.float64) - want).abs().max()
    return float(diff / want.abs().max())

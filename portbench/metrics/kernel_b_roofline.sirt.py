"""kernel_b_roofline.sirt: kernel B's (affine_slab) least time at the
published peaks over its measured device time in SIRT's forward, %."""

from portbench.metrics import _read


def read(record):
    return _read.roofline_pct(record, "kernel_b")

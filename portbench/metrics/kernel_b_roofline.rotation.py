"""kernel_b_roofline.rotation: kernel B's (affine_slab) least time at the
H100's published peaks (roofline/) over its measured device time, %."""

from portbench.metrics import _read


def read(record):
    return _read.roofline_pct(record, "kernel_b")

"""kernel_c_roofline.sirt: kernel C's (backproject) least time at the
published peaks over its measured device time in SIRT, %."""

from portbench.metrics import _read


def read(record):
    return _read.roofline_pct(record, "kernel_c")

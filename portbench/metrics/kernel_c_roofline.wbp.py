"""kernel_c_roofline.wbp: kernel C's least time at the published peaks over
its measured device time in WBP, %."""

from portbench.metrics import _read


def read(record):
    return _read.roofline_pct(record, "kernel_c")

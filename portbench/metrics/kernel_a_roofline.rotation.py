"""kernel_a_roofline.rotation: kernel A's least time at the H100's
published peaks (roofline/) over its measured device time, %."""

from portbench.metrics import _read


def read(record):
    return _read.roofline_pct(record, "kernel_a")

"""kernel_a_ms.linear: device ms per launch of kernel A
(affine_resample), CUDA events around each launch queued behind a sleep
kernel."""

from portbench.metrics import _read


def read(record):
    return _read.device_ms_mean(record, "kernel_a")

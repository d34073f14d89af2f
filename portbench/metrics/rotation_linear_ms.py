"""rotation_linear_ms: the window's wall time, closed by a synchronize,
over the rotations it completed."""

from portbench.metrics import _read


def read(record):
    return _read.per_call_ms(record)

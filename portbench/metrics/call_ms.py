"""call_ms: the mean latency of a synchronous call in a closed loop with
one caller: the window's wall time over the calls it completed."""

from portbench.metrics import _read


def read(record):
    return _read.per_call_ms(record)

"""sirt_ms: the window's wall time over the reconstructions it completed,
each call ending in a synchronize."""

from portbench.metrics import _read


def read(record):
    return _read.per_call_ms(record)

"""device_idle.wbp: 1 - busy / wall over replayed calls: busy from the
calls queued behind a sleep kernel, wall from the same calls called
live, %."""

from portbench.metrics import _read


def read(record):
    return _read.idle_pct(record)

"""device_idle.tm: 1 - busy / wall over the template-matching driver's
traced pass: busy, the union of the device intervals the program's tracer
recorded; wall, the pass's own, closed by a synchronize, %."""

from portbench.metrics import _read


def read(record):
    return _read.idle_pct(record)

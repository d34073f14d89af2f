"""forward_ms.sirt: device ms per call of SIRT's forward sweep
(project_stack: kernel B's and A's chunks and the stack sums), one call
an iteration and one for the row sums."""

from portbench.metrics import _read


def read(record):
    return _read.device_ms_mean(record, "forward")

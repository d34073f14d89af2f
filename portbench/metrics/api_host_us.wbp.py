"""api_host_us.wbp: host us per call of wbp_reconstruct, entry to return,
the calls queued behind a sleep kernel."""

from portbench.metrics import _read


def read(record):
    return _read.host_us_per_call(record, "api")

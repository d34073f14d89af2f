"""api_host_us.rotation: host us per call of StaticVolume.affine, entry to
return, the calls queued behind a sleep kernel (no launch queue to wait
on)."""

from portbench.metrics import _read


def read(record):
    return _read.host_us_per_call(record, "api")

"""planner_host_us.linear: host us per call in transforms.route and
transforms.walk_patch."""

from portbench.metrics import _read


def read(record):
    return _read.host_us_per_call(record, "planner")

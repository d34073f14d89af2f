"""What the metric readers share.  Each reader takes the run's record (the
driver's window, and with ``--trace 1`` its ``trace``) and returns a
number, or None where the record holds nothing for it."""

from __future__ import annotations

import numpy as np


def per_call_ms(record):
    """The window's wall time over the calls it completed, ms."""
    if not record.get("completed"):
        return None
    return record["window_s"] / record["completed"] * 1e3


def host_us_per_call(record, name):
    """Host us of the spans ``name`` per replayed call."""
    trace = record.get("trace") or {}
    spans = trace.get("host_s", {}).get(name)
    if not spans:
        return None
    return sum(spans) / trace["calls"] * 1e6


def device_ms_mean(record, name):
    """Mean device ms of the spans ``name``."""
    spans = (record.get("trace") or {}).get("device_ms", {}).get(name)
    return float(np.mean(spans)) if spans else None


def roofline_pct(record, name):
    """The least time of the launches ``name`` at the published peaks over
    their measured device time, %."""
    trace = record.get("trace") or {}
    spans = trace.get("device_ms", {}).get(name)
    least = trace.get("least_ms", {}).get(name)
    if not spans or not least:
        return None
    return 100.0 * sum(least) / sum(spans)


def idle_pct(record):
    """1 - busy / wall over the replayed calls, %."""
    trace = record.get("trace") or {}
    if not trace.get("wall_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["wall_s"])

"""call_p95_ms: the 95th percentile of the window's per-call latencies
(host clock from entry to a synchronize on the result), over all its
calls; read only where the window completed at least 200."""

import numpy as np


def read(record):
    latencies = record.get("latencies_ms") or []
    if len(latencies) < 200:
        return None
    return float(np.percentile(latencies, 95))

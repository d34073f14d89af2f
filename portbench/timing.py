"""Clocks and spans: CUDA events, device spans queued behind a sleep
kernel, and host spans on ``time.perf_counter``.

``queued_ms`` is frozen from ``chip_smoke.py:734`` and ``patched`` follows
``queued_launch_ms`` (``chip_smoke.py:698``): a launch is wrapped where its
caller looks it up, from this package, never inside the program.  Calls
queued behind a sleep kernel run on the device back to back, so the time
between their first and last event is the device's busy time, and events
recorded just before and just after one launch bound that launch alone:
the host's work falls into the sleep.  The host must have queued the
calls before the sleep ends; where it has not (a call that synchronises
inside, or a launch queue that fills), :class:`QueueError` says so.

torch.profiler is not a source here: on the H100 machine it drops the
device events of the port's ctypes kernels.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class QueueError(RuntimeError):
    """The host had not queued the calls when the sleep kernel ended."""


def event(torch):
    return torch.cuda.Event(enable_timing=True)


def sleep_cycles_per_ms(torch, cycles: int = 10 ** 7) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per device millisecond."""
    torch.cuda._sleep(cycles)          # the first call loads its kernel
    torch.cuda.synchronize()
    start, end = event(torch), event(torch)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def queued_ms(torch, calls, sleep_cycles: int):
    """Run ``calls`` (callables) queued behind a sleep kernel of
    ``sleep_cycles``.  Returns (device ms from the end of the sleep to the
    end of the last call, host ms the queueing took, sleep ms)."""
    sleep_start, sleep_end, done = event(torch), event(torch), event(torch)
    torch.cuda.synchronize()
    sleep_start.record()
    torch.cuda._sleep(int(sleep_cycles))
    sleep_end.record()
    t0 = time.perf_counter()
    for call in calls:
        call()
    host_ms = (time.perf_counter() - t0) * 1e3
    done.record()
    torch.cuda.synchronize()
    sleep_ms = sleep_start.elapsed_time(sleep_end)
    if host_ms >= sleep_ms:
        raise QueueError(
            f"the host took {host_ms:.3f} ms to queue {len(calls)} calls "
            f"behind a {sleep_ms:.3f} ms sleep: a call waits on the device "
            f"inside, or the launch queue filled")
    return sleep_end.elapsed_time(done), host_ms, sleep_ms


class Spans:
    """Host spans (seconds, by name), device spans (CUDA event pairs, by
    name) and notes (per launch, what the roofline needs).  Host spans are
    recorded while ``on_host``; device spans of the name ``on_device``
    only, for at most ``budget`` more launches: each pair of events takes
    two places in the launch queue, which holds about a thousand."""

    def __init__(self):
        self.host = defaultdict(list)
        self.device = defaultdict(list)
        self.notes = defaultdict(list)
        self.on_host = False
        self.on_device = None
        self.budget = 0

    def device_ms(self, name):
        """Per-span ms of the device spans ``name`` (synchronise first)."""
        return [a.elapsed_time(b) for a, b in self.device[name]]


@contextlib.contextmanager
def patched(torch, module, attr: str, spans: Spans, name: str,
            device: bool = True, note=None):
    """Wrap ``module.attr`` for the duration: a host span ``name`` around
    each call while ``spans.on_host``; with ``device``, CUDA events just
    before and just after it, and ``note(args, kwargs)`` as its note,
    while ``spans.on_device`` is ``name`` and its budget lasts."""
    original = getattr(module, attr)

    def wrapper(*args, **kwargs):
        if device and spans.on_device == name and spans.budget > 0:
            spans.budget -= 1
            ev = (event(torch), event(torch))
            ev[0].record()
            out = original(*args, **kwargs)
            ev[1].record()
            spans.device[name].append(ev)
            if note is not None:
                spans.notes[name].append(note(args, kwargs))
            return out
        if spans.on_host:
            t0 = time.perf_counter()
            out = original(*args, **kwargs)
            spans.host[name].append(time.perf_counter() - t0)
            return out
        return original(*args, **kwargs)

    setattr(module, attr, wrapper)
    try:
        yield
    finally:
        setattr(module, attr, original)

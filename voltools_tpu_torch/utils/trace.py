"""The port's tracer: host spans and the device's work on one clock, and
counters.

Off by default.  While it is off, an instrumented site costs one check of a
module-level flag: :func:`span` and :func:`device_work` return one shared
null context, and nothing reads a clock, allocates, formats or records an
event.  :func:`count` counts while the tracer is on, an integer add in a
dict of the calling thread; a site whose counter's arguments cost
something to form reads :data:`ON` first.

A span records its name, its start and end on ``time.perf_counter_ns``, its
``parent`` (the span open on its thread when it opened), its ``call`` (the
outermost span open on the thread then, which every span of one API call
shares) and its thread.

With ``start(device=True)``, a span opened with ``device=True`` (or with
the device its work runs on) and a :func:`device_work` block also record
the device's interval of the work they queue, owned by the span (for
:func:`device_work`, the span open around it).  Each records one CUDA event
on the current stream as it closes: the work's end.  Its start is the later
of the end of the interval before it on that stream and the host's exit
from the block: a launch or a copy starts only once made, and the last
call of a block makes its last work.  So a block should queue one piece
of work, or pieces behind work already queued, and every piece of work on
the stream needs an interval, or the next one absorbs it.  A start event
would cost a second record and say less: on an idle stream it fires as
the host records it, before the host has made the work, and a pause of
the host (a collection, a page fault) then counts as device time.  The
events go onto the host clock through anchors: :func:`start`, :func:`mark` and
:func:`stop` synchronise the device, record an event on its empty stream
and read the host clock as it completes; :func:`export` places each event
between the anchors either side of it, so the two clocks' drift over a
long stretch is taken out.

Everything is kept in memory until :func:`export`, which returns one
Chrome trace-event object (``traceEvents``, ``ts`` and ``dur`` in us on the
host clock; the host and the device as two tracks) that Perfetto opens;
:func:`idle_gaps` reads it.  The records are tuples of numbers and names,
which the garbage collector stops tracking, so a long trace does not make
its collections slower.  torch.profiler is no substitute: it drops the
device events of the port's ctypes kernels.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

OUTSIDE = "outside the program"
HOST, DEVICE = 1, 2          # the export's two tracks (trace-event pids)

# CUDA events a device keeps made and recorded once, more than a traced
# second of the benchmark's busiest cell records (two a rotation): a record
# that also makes its event (cudaEventCreate) costs the host more inside
# the trace than one of a made event
POOL_EVENTS = 16384

ON = False                   # spans and counters are recorded
_EVENTS_ON = False           # and device work
_SPANS: list = []            # (id, parent, call, thread, name, start ns,
#                              end ns, notes or None), as they closed
_WORK: list = []             # (owner span id, device index, anchor position,
#                              start bound ns, event slot, stream id)
_ANCHORS: dict = {}          # device index -> [(host ns, event slot,
#                              bracket width ns)]
_WINDOWS: list = []          # [host ns from, host ns to, or None while open]
_EVENTS: dict = {}           # device index -> CUDA events, by slot
_FREE: dict = {}             # device index -> slots free to record
_STREAMS: dict = {}          # device index -> (stream id, torch stream)
_IDS = itertools.count(1)
_LOCAL = threading.local()   # .stack: open spans; .counts: counters
_THREAD_COUNTS: list = []    # every thread's counter dict
_COUNTS_LOCK = threading.Lock()
# the current stream's id, read without making a stream object
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


class _Null:
    """What :func:`span` and :func:`device_work` return while off.  Its
    ``with`` methods are C callables, so a site runs no Python frame for
    them: ``tuple()`` is the empty tuple, ``"".format(*exc_info)`` the empty
    string (false, so an exception goes on)."""

    __slots__ = ()
    __enter__ = tuple
    __exit__ = "".format

    def note(self, **args):
        pass


_NULL = _Null()


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


def _slot(index: int) -> int:
    """A free event slot of device ``index`` (a new event when none is)."""
    free = _FREE.get(index)
    if free:
        return free.pop()
    events = _EVENTS.setdefault(index, [])
    events.append(torch.cuda.Event(enable_timing=True))
    return len(events) - 1


def _fill(index: int) -> None:
    """Make device ``index`` hold ``POOL_EVENTS`` events, each recorded
    once (so made), and free them all."""
    events = _EVENTS.setdefault(index, [])
    stream = torch.cuda.current_stream(index)
    while len(events) < POOL_EVENTS:
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        events.append(event)
    _FREE[index] = list(range(len(events)))


def _stream(index: int):
    """(id, stream) of device ``index``'s current stream, the stream object
    made again only when the current stream changed."""
    found = _STREAMS.get(index)
    if _RAW_STREAM is not None and found is not None \
            and found[0] == _RAW_STREAM(index):
        return found
    stream = torch.cuda.current_stream(index)
    found = _STREAMS[index] = (stream.cuda_stream, stream)
    return found


def _anchor(index: int) -> list:
    """Synchronise device ``index`` and record events on its empty stream,
    each between a read of the host clock before it and one once it has
    completed; the narrowest such bracket of three anchors the device's
    clock at its middle, within half its width.  Returns the device's
    anchors.  A device's first anchor fills its events."""
    if index not in _FREE:
        _fill(index)
    torch.cuda.synchronize(index)
    stream = _stream(index)[1]
    best = None
    for _ in range(3):
        slot = _slot(index)
        event = _EVENTS[index][slot]
        before = time.perf_counter_ns()
        event.record(stream)
        while not event.query():
            pass
        width = time.perf_counter_ns() - before
        if best is None or width < best[2]:
            best = (before + width // 2, slot, width)
    anchors = _ANCHORS.setdefault(index, [])
    anchors.append(best)
    return anchors


def _record(device, owner, bound: int) -> None:
    """Record the end of the work queued on ``device`` (True: the current
    device; a tensor: its device) for span ``owner``, its start bounded by
    ``bound``, the host's exit from the block; nothing off a CUDA
    device."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is True:
        index = torch.cuda.current_device()
    elif isinstance(device, torch.device) and device.type == "cuda":
        index = (torch.cuda.current_device() if device.index is None
                 else device.index)
    else:
        return
    anchors = _ANCHORS.get(index) or _anchor(index)
    stream_id, stream = _stream(index)
    slot = _slot(index)
    _EVENTS[index][slot].record(stream)
    _WORK.append((owner, index, len(anchors) - 1, bound, slot, stream_id))


class _Span:
    __slots__ = ("name", "device", "id", "parent", "call", "start", "args")

    def __init__(self, name, device):
        self.name = name
        self.device = device
        self.args = None

    def __enter__(self):
        stack = _stack()
        self.id = next(_IDS)
        if stack:
            top = stack[-1]
            self.parent, self.call = top.id, top.call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.device is not False and _EVENTS_ON:
            _record(self.device, self.id, time.perf_counter_ns())
        _LOCAL.stack.pop()
        _SPANS.append((self.id, self.parent, self.call,
                       threading.get_ident(), self.name, self.start,
                       time.perf_counter_ns(), self.args))
        return None

    def note(self, **args):
        """Attributes that the export shows with the span."""
        self.args = {**(self.args or {}), **args}


class _Work:
    __slots__ = ("device", "owner")

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        stack = _stack()
        self.owner = stack[-1].id if stack else None
        return self

    def __exit__(self, *exc):
        _record(self.device, self.owner, time.perf_counter_ns())
        return None


def span(name: str, device=False):
    """A span ``name`` around the ``with`` block while the tracer is on.
    ``device``: True (the current device), or the ``torch.device`` or a
    tensor whose device the block's work runs on, also records the
    device's interval of the work the block queues, as
    :func:`device_work` does (with ``start(device=True)``; nothing off a
    CUDA device; a tensor's device is read only then).  The context's
    ``note(**args)`` attaches attributes."""
    if not ON:
        return _NULL
    return _Span(name, device)


def device_work(device=True):
    """Record the device's interval of the work the ``with`` block queues
    on ``device`` (as for :func:`span`; True: the current device), owned by
    the span open around it, while the tracer is on with ``device=True``.
    For a launch or a copy inside a span whose host work is wider than
    it."""
    if not _EVENTS_ON:
        return _NULL
    return _Work(device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on.  Each
    thread counts in a dict of its own, so no update is lost."""
    if not ON:
        return
    try:
        mine = _LOCAL.counts
    except AttributeError:
        mine = _LOCAL.counts = {}
        with _COUNTS_LOCK:
            _THREAD_COUNTS.append(mine)
    mine[name] = mine.get(name, 0) + n


def counts() -> dict:
    """Every counter of this process: :func:`count`'s, summed over
    threads; and, read from the state that holds them, the kernels' launch
    counters (``launches.<kernel>``, their ``launches`` attributes) and
    the kernel libraries loaded (``load.<name>``) and built by nvcc
    (``build.<name>``) in this process."""
    from ..kernels import _build, affine_resample, affine_slab, backproject
    from ..kernels import partial_sample as ps
    total: dict = {}
    with _COUNTS_LOCK:
        mine = list(_THREAD_COUNTS)
    for counter in mine:
        for name, n in list(counter.items()):
            total[name] = total.get(name, 0) + n
    for fn in (affine_resample.affine_resample, affine_slab.affine_slab,
               backproject.backproject, ps.partial_sample,
               ps.partial_sample_ring, ps.partial_project):
        total[f"launches.{fn.__name__}"] = fn.launches
    total["launches.partial_project.line"] = ps.partial_project.line_launches
    total["launches.affine_slab.rows"] = affine_slab.affine_slab.row_launches
    for name in list(_build._LOADED):
        total[f"load.{name}"] = 1
    for name in list(_build.BUILD_LOG):
        total[f"build.{name}"] = 1
    return total


def start(device: bool = False) -> None:
    """Forget what was recorded and turn the tracer on.  ``device``: also
    record the device's work on the spans and blocks that ask for it; the
    current CUDA device is synchronised and anchored here (it must
    exist)."""
    global ON, _EVENTS_ON
    for index, events in _EVENTS.items():
        _FREE[index] = list(range(len(events)))
    _SPANS.clear()
    _WORK.clear()
    _ANCHORS.clear()
    _WINDOWS.clear()
    _EVENTS_ON = bool(device)
    if _EVENTS_ON:
        _anchor(torch.cuda.current_device())
    _WINDOWS.append([time.perf_counter_ns(), None])
    ON = True


def mark() -> None:
    """Close the current window, anchor every device the tracer has seen
    anew (the two clocks drift apart) and open the next window.  The time
    between the windows, this call's own, is no part of the traced
    wall."""
    if _WINDOWS and _WINDOWS[-1][1] is None:
        _WINDOWS[-1][1] = time.perf_counter_ns()
    for index in list(_ANCHORS):
        _anchor(index)
    _WINDOWS.append([time.perf_counter_ns(), None])


def stop() -> None:
    """Turn the tracer off and close its window; what was recorded stays
    for :func:`export`.  With device work, anchors every device the tracer
    has seen once more, so that the last window's events lie between two
    anchors."""
    global ON, _EVENTS_ON
    if _WINDOWS and _WINDOWS[-1][1] is None:
        _WINDOWS[-1][1] = time.perf_counter_ns()
    if _EVENTS_ON:
        for index in list(_ANCHORS):
            _anchor(index)
    ON = _EVENTS_ON = False


def _device_counters() -> dict:
    """The kernels' counters on the device, summed over the devices the
    tracer anchored (each read waits for its device)."""
    from ..kernels.affine_resample import fast_path_voxels
    from ..kernels.affine_slab import overflows
    from ..kernels.backproject import window_misses
    from ..kernels.match_update import improved_voxels
    found = {"fast_path_voxels": 0, "overflows": 0, "window_misses": 0,
             "improved_voxels": 0}
    for index in _ANCHORS:
        device = torch.device("cuda", index)
        found["fast_path_voxels"] += fast_path_voxels(device)
        found["overflows"] += overflows(device)
        found["window_misses"] += window_misses(device)
        found["improved_voxels"] += improved_voxels(device)
    return found


def export() -> dict:
    """What was recorded, as one Chrome trace-event object: an ``X`` event
    per span on the host track (pid ``HOST``, tid its thread; ``args``
    ``id``, ``parent``, ``call`` and its notes) and per device interval on
    the device track (pid ``DEVICE``, tid the device index, named after
    its span; ``args.span`` that span's id), ``ts`` and ``dur`` in us on
    the host clock from the first window's start.  ``otherData`` holds
    the windows, the anchors and the counters.  Synchronises the anchored
    devices once, then reads their counters."""
    for index in _ANCHORS:
        torch.cuda.synchronize(index)
    now = time.perf_counter_ns()
    origin = _WINDOWS[0][0] if _WINDOWS else now

    def us(ns):
        return (ns - origin) / 1e3

    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "args": {"name": name}}
              for pid, name in ((HOST, "host"), (DEVICE, "device"))]
    names = {}
    for id_, parent, call, thread, name, t0, t1, notes in _SPANS:
        names[id_] = name
        args = {"id": id_, "parent": parent, "call": call, **(notes or {})}
        events.append({"name": name, "ph": "X", "pid": HOST, "tid": thread,
                       "ts": us(t0), "dur": (t1 - t0) / 1e3, "args": args})
    ends = [(index, stream, _host_ns(index, pos, slot), bound, owner)
            for owner, index, pos, bound, slot, stream in _WORK]
    # work on one stream runs in order: each interval starts no earlier
    # than the one before it ended
    ends.sort()
    last = None
    for index, stream, end, bound, owner in ends:
        begin = bound if last is None or last[:2] != (index, stream) \
            else max(bound, last[2])
        begin = min(begin, end)
        last = (index, stream, end)
        events.append({"name": names.get(owner, OUTSIDE), "ph": "X",
                       "pid": DEVICE, "tid": index, "ts": us(begin),
                       "dur": (end - begin) / 1e3, "args": {"span": owner}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {
                "clock": "time.perf_counter_ns", "origin_ns": origin,
                "windows": [[us(a), us(now if b is None else b)]
                            for a, b in _WINDOWS],
                "anchors": {str(index): [[us(ns), width / 1e3]
                                         for ns, _, width in anchors]
                            for index, anchors in _ANCHORS.items()},
                "counters": {**counts(), **_device_counters()}}}


def _host_ns(index: int, pos: int, slot: int) -> float:
    """The host clock of event ``slot`` of device ``index``, recorded
    after anchor ``pos``: between that anchor and the next, at the rate the
    two clocks kept between them, or by the anchor alone when it is the
    last."""
    anchors, events = _ANCHORS[index], _EVENTS[index]
    ns, anchor, _ = anchors[pos]
    ms = events[anchor].elapsed_time(events[slot])
    if pos + 1 < len(anchors):
        ns_next, following, _ = anchors[pos + 1]
        between_ms = events[anchor].elapsed_time(events[following])
        if between_ms > 0:
            return ns + ms * (ns_next - ns) / between_ms
    return ns + ms * 1e6


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _intersect(xs, ys):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(xs, ys):
    """``xs`` less ``ys``, both sorted lists of disjoint intervals."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k, cursor = j, a
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > cursor:
                out.append([cursor, ys[k][0]])
            cursor = max(cursor, ys[k][1])
            k += 1
        if cursor < b:
            out.append([cursor, b])
    return out


def _charge(idle, host) -> dict:
    """us of the ``idle`` intervals by the deepest host span open (the
    latest to start), ``OUTSIDE`` where none is."""
    bounds = []
    for i, (s, e, name) in enumerate(host):
        bounds.append((s, 1, i, name))
        bounds.append((e, 0, i, name))
    bounds.sort()                     # at one instant, ends before starts
    charged: dict = {}
    open_spans: dict = {}
    k = 0

    def apply(upto, inclusive):
        nonlocal k
        while k < len(bounds) and (bounds[k][0] < upto or (
                inclusive and bounds[k][0] == upto)):
            t, starts, i, name = bounds[k]
            if starts:
                open_spans[i] = (t, i, name)
            else:
                open_spans.pop(i, None)
            k += 1

    def add(us):
        if us > 0:
            name = max(open_spans.values())[2] if open_spans else OUTSIDE
            charged[name] = charged.get(name, 0.0) + us

    for a, b in idle:
        apply(a, True)
        cursor = a
        while k < len(bounds) and bounds[k][0] < b:
            t = bounds[k][0]
            add(t - cursor)
            apply(t, True)
            cursor = t
        add(b - cursor)
    return charged


def idle_gaps(trace: dict) -> dict:
    """Where the device sat idle in an :func:`export`, by what the host was
    doing.  The device is busy over the union of the device intervals;
    every other instant of the windows is idle and is charged to the
    deepest host span open then (the latest to start), or to ``OUTSIDE``.
    Returns ``idle_s`` (seconds by span name), ``busy_s`` and ``wall_s``
    (the windows' total); the idle seconds sum to the wall less the
    busy."""
    windows = _union(trace.get("otherData", {}).get("windows", []))
    host, device = [], []
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            interval = (e["ts"], e["ts"] + e["dur"], e["name"])
            (device if e["pid"] == DEVICE else host).append(interval)
    busy = _intersect(_union([(a, b) for a, b, _ in device]), windows)
    idle = _subtract(windows, busy)
    return {"idle_s": {k: v / 1e6 for k, v in _charge(idle, host).items()},
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "wall_s": sum(b - a for a, b in windows) / 1e6}

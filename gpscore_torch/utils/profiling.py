"""Tracing helpers (port of `gpscore/utils/profiling.py`), and the program's
spans.

- :func:`span`: a span around a phase of the program (a fit, the GD loop's
  eager steps and capture, the large-n cores' forward and backward, each
  call of the Gram kernels' dispatchers). It
  records only while torch.profiler records in the process; otherwise it
  costs one flag read. A finished span goes into a bounded in-memory log
  that :func:`spans` reads.
- :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace (for
  Perfetto or ``chrome://tracing``) into a directory, with the spans
  recorded inside it on the kernels' timeline, and yields the profiler,
  whose ``events()`` the caller may sum. A CUDA graph's replay shows in it as
  the graph's kernels, one device event each.

Per-iteration loss and parameter histories are outputs of the fit
(``fit_gd(..., record_params=True)``), not of the profiler.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.autograd import _profiler_enabled

# Finished spans kept in memory; past it the oldest go and are counted.
SPAN_LOG_CAPACITY = 65_536


@dataclass
class Span:
    """One finished span. ``start_ns`` and ``end_ns`` are host times on the
    profiler's clock (``time.time_ns``, as Kineto stamps host events);
    ``device_ms`` is the device time between two CUDA events recorded on the
    span's stream at its start and end, or None where the span timed no
    device work (a host-only span, work on the CPU, a stream capturing)."""

    id: int
    parent: Optional[int]  # the innermost span open on the same thread
    root: Optional[int]  # the ``fit`` span open in the process (a fit is its own)
    name: str
    attrs: dict
    thread: int  # the thread's native id, as the profiler's host events carry
    start_ns: int
    end_ns: int
    device_ms: Optional[float] = None
    _events: Optional[tuple] = field(default=None, repr=False, compare=False)


class _SpanLog:
    """The finished spans of the process, the open ``fit`` span and each
    thread's open spans. Spans close on the autograd engine's threads too, so
    writes take the lock."""

    def __init__(self, capacity: int = SPAN_LOG_CAPACITY):
        self.done = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.next_id = 0
        self.fit = None  # id of the open fit span
        self.lock = threading.Lock()
        self.local = threading.local()

    def add(self, rec: Span) -> None:
        with self.lock:
            if len(self.done) == self.done.maxlen:
                self.dropped += 1
            self.done.append(rec)

    def read(self):
        with self.lock:
            recs = list(self.done)
            for r in recs:
                if r._events is not None:
                    start, end = r._events
                    end.synchronize()
                    r.device_ms, r._events = start.elapsed_time(end), None
            return recs, self.dropped


_LOG = _SpanLog()


class _Recording:
    """The context of one span while the profiler records."""

    __slots__ = ("name", "device", "attrs", "rec", "stack", "fit_before", "stream", "start")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs
        self.stream = self.start = None

    def __enter__(self):
        log = _LOG
        stack = getattr(log.local, "stack", None)
        if stack is None:
            stack = log.local.stack = []
        with log.lock:
            sid = log.next_id
            log.next_id += 1
        if self.name == "fit":
            self.fit_before, log.fit = log.fit, sid
        self.rec = Span(sid, stack[-1] if stack else None, log.fit, self.name, self.attrs,
                        threading.get_native_id(), time.time_ns(), 0)
        self.stack = stack
        stack.append(sid)
        device = self.device
        if (device is not None and torch.device(device).type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            self.stream = torch.cuda.current_stream(device)
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self.rec

    def __exit__(self, *exc):
        rec = self.rec
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            rec._events = (self.start, end)
        rec.end_ns = time.time_ns()
        self.stack.pop()
        if self.name == "fit":
            _LOG.fit = self.fit_before
        _LOG.add(rec)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device=None, **attrs):
    """A context manager that records the enclosed phase as a :class:`Span`
    while torch.profiler records in the process, and does nothing otherwise
    (one flag read; no allocation, no CUDA call). ``device``: where the
    phase's work runs; on a CUDA card the span also takes the device time
    between two CUDA events on the current stream (none while the stream
    captures a graph). ``attrs`` are kept as given (counts: steps,
    iterations, passes). A span named ``fit`` is the root of the spans that
    begin, on any thread, while it is open."""
    if not _profiler_enabled():
        return _OFF
    return _Recording(name, device, attrs)


def spans():
    """(the finished spans in the log, oldest first; the number dropped from
    it). Synchronizes on the spans' pending CUDA events and resolves their
    device times; clears nothing."""
    return _LOG.read()


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _span_events(recs, base_ns: int) -> list:
    """The spans as Chrome-trace complete events on the trace's timeline."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "gpscore_torch.span", "name": r.name, "pid": pid,
             "tid": r.thread, "ts": (r.start_ns - base_ns) / 1e3,
             "dur": (r.end_ns - r.start_ns) / 1e3,
             "args": {"id": r.id, "parent": r.parent, "root": r.root,
                      "device_ms": r.device_ms, **{k: str(v) for k, v in r.attrs.items()}}}
            for r in recs]


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace"):
    """Profile the enclosed block (CPU, and CUDA where there is a card) and
    write ``<logdir>/<name>.json``, a Chrome trace that also holds the spans
    recorded inside the block. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first = _LOG.next_id
    with profile(activities=activities) as prof:
        yield prof
        _synchronize()
    path = os.path.join(logdir, f"{name}.json")
    prof.export_chrome_trace(path)
    recs = [r for r in spans()[0] if r.id >= first]
    if recs:
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"] += _span_events(recs, int(doc.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(doc, f)


def device_events(prof) -> list:
    """The profiler's device-side events: kernels, copies and memsets."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

"""Timing and tracing helpers (port of `gpscore/utils/profiling.py`).

- :func:`timed`: seconds per call of a callable, after warm-up calls, with the
  device synchronized around the timed calls (``torch.cuda.synchronize`` where
  there is a card; PyTorch returns before the device has finished).
- :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace (for
  Perfetto or ``chrome://tracing``) into a directory and yields the profiler,
  whose ``events()`` the caller may sum. A CUDA graph's replay shows in it as
  the graph's kernels, one device event each.

Per-iteration loss and parameter histories are outputs of the fit
(``fit_gd(..., record_params=True)``), not of the profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, warmup: int = 1, repeats: int = 3) -> Tuple[float, object]:
    """(seconds per call, last result) of ``fn(*args)``: ``warmup`` calls
    first (kernel build, library set-up), then ``repeats`` timed calls between
    two device synchronizations."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    _synchronize()
    return (time.perf_counter() - t0) / repeats, out


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace"):
    """Profile the enclosed block (CPU, and CUDA where there is a card) and
    write ``<logdir>/<name>.json``, a Chrome trace. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


def device_events(prof) -> list:
    """The profiler's device-side events: kernels, copies and memsets."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

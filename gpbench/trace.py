"""The benchmark's own tracing: torch.profiler spans around calls into the
program, reduced to device busy time, device events by name and kind, idle
gaps labelled by what the host was doing, and the Gram kernels' launches.

The reduction reads the profiler's raw (Kineto) events, not
``prof.events()``, whose Python objects cost too much at a few million
events. A span exports no Chrome trace.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from gpbench.frozen.kernel_kind import KINDS, kernel_kind

# The Gram kernels' device names and the program's launch counter keys
# (``gpscore_torch.ops.gram_cuda.LAUNCHES``), the more specific name first.
GRAM_KERNELS = (("gram_fwd_kernel_dchunk", "fwd_dchunk"), ("gram_fwd_kernel", "fwd"),
                ("gram_bwd_rows_kernel", "bwd_rows"), ("gram_bwd_cols_kernel", "bwd_cols"))


def gram_key(name: str):
    """The LAUNCHES key of a device kernel's name, or None for a non-Gram kernel."""
    return next((key for sub, key in GRAM_KERNELS if sub in name), None)


@dataclass
class Span:
    """One profiled call: its host wall time and its device activity."""

    wall_s: float
    n_device: int = 0
    busy_sum_us: float = 0.0  # sum of the device events' durations
    busy_union_us: float = 0.0  # length of the union of their intervals
    by_name: dict = field(default_factory=dict)  # name -> [count, us]
    gram_events: dict = field(default_factory=dict)  # LAUNCHES key -> events
    gaps: list = field(default_factory=list)  # [(seconds, host label)] longest first
    launches: dict = field(default_factory=dict)  # LAUNCHES delta over the span

    def kind_us(self) -> dict:
        out = {k: 0.0 for k in KINDS}
        for name, (_, us) in self.by_name.items():
            out[kernel_kind(name)] += us
        return out

    def gram_complete(self) -> bool:
        """Whether every Gram launch the program counted left a device event."""
        keys = set(self.launches) | set(self.gram_events)
        return all(self.gram_events.get(k, 0) == self.launches.get(k, 0) for k in keys)


def _reduce(prof, wall_s: float, max_gaps: int = 10) -> Span:
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.device_type() == DeviceType.CPU and e.duration_ns() > 0:
            cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    span = Span(wall_s=wall_s, n_device=len(dev))
    if not dev:
        return span
    dev.sort()
    by_name, gram = {}, {}
    merged = []
    for s, t, name in dev:
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (t - s) / 1e3
        key = gram_key(name)
        if key is not None:
            gram[key] = gram.get(key, 0) + 1
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    span.by_name, span.gram_events = by_name, gram
    span.busy_sum_us = sum(us for _, us in by_name.values())
    span.busy_union_us = sum(t - s for s, t in merged) / 1e3
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:max_gaps]
    span.gaps = [(g / 1e9, _host_label(cpu, a, b)) for g, a, b in gaps]
    return span


def _host_label(cpu, a, b) -> str:
    """The innermost host operation that covers the middle of the gap [a, b]."""
    mid = (a + b) // 2
    best = None
    for s, t, name in cpu:
        if s <= mid <= t and (best is None or t - s < best[0]):
            best = (t - s, name)
    return best[1] if best else "host, no profiled operation"


def profile(fn, launches=None) -> Span:
    """``fn()`` under torch.profiler (host and device), between device
    synchronizations. ``launches``, a dict the program updates (its Gram
    launch counter), gives the span's delta in ``Span.launches``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    before = dict(launches) if launches is not None else {}
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    span = _reduce(prof, wall)
    if launches is not None:
        span.launches = {k: v - before.get(k, 0) for k, v in launches.items()
                         if v - before.get(k, 0)}
    return span


def profile_complete(fn, launches, tries: int = 5):
    """:func:`profile` retaken until the Gram events recorded equal the
    launches counted, at most ``tries`` times (torch.profiler drops events
    on that machine at some shapes). Returns (the last span, the number of
    takes, whether it is complete)."""
    for take in range(1, tries + 1):
        span = profile(fn, launches)
        if span.gram_complete():
            return span, take, True
    return span, tries, False


def breakdown(spans) -> dict:
    """The ``breakdown`` of a traced run: the ten device operations that took
    most time over ``spans``, and the longest idle gaps grouped by what the
    host was doing."""
    by_name, gaps = {}, {}
    for sp in spans:
        for name, (_, us) in sp.by_name.items():
            by_name[name] = by_name.get(name, 0.0) + us / 1e6
        for sec, label in sp.gaps:
            gaps[label] = gaps.get(label, 0.0) + sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in top_gaps]}

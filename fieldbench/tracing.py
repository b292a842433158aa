"""The device trace of a window, reduced to what the readers need.

A traced window runs under ``torch.profiler`` (CPU and CUDA activities)
inside a ``fieldbench.window`` annotation.  :func:`reduce` turns the
profiler's events into plain data: every device operation (name, start,
duration), the seconds in which an operation ran on the device (the union
of their intervals), the ten device operations that took most time and the
ten longest idle stretches by what the host was doing in them.  The events
are read straight from the profiler's result, without the per-event
objects that ``key_averages`` builds.
"""
from __future__ import annotations

import contextlib

import numpy as np

WINDOW = "fieldbench.window"
#: idle stretches labelled for the breakdown, longest first
GAPS_LABELLED = 400


@contextlib.contextmanager
def profiled():
    """Profile the CPU and the card inside; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield prof


def reduce(prof, window_s: float) -> dict:
    """Device operations, busy seconds and the breakdown of one profiled
    window of ``window_s`` host seconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    w0 = w1 = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # the harness's own annotations are mirrored onto the device's
            # timeline as spans over the work they enclose: not operations
            dur = e.duration_ns()
            if dur > 0 and not e.is_user_annotation() and \
                    not name.startswith("fieldbench."):
                dev.append((name, e.start_ns(), dur))
        else:
            if name == WINDOW:
                w0, w1 = e.start_ns(), e.end_ns()
            elif e.end_ns() > e.start_ns():
                host.append((name, e.start_ns(), e.end_ns()))
    busy_ns, gaps = _busy_and_gaps(dev, w0, w1)
    by = {}
    for name, _, dur in dev:
        by[name] = by.get(name, 0) + dur
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": dev,
            "busy_s": busy_ns / 1e9,
            "window_s": window_s,
            "breakdown": {
                "device_ops": [[n[:100], ns / 1e9] for n, ns in top],
                "idle_gaps": _label_gaps(gaps, host)}}


def _busy_and_gaps(dev, w0, w1):
    """The length of the union of the device intervals inside ``[w0, w1]``
    (the span of the intervals when no annotation was read), and the idle
    stretches between them."""
    spans = sorted((s, s + d) for _, s, d in dev)
    if w0 is None:
        w0 = spans[0][0] if spans else 0
        w1 = spans[-1][1] if spans else 0
    busy, gaps, cur = 0, [], w0
    for s, e in spans:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        busy += max(0, e - max(s, cur))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def _label_gaps(gaps, host) -> list:
    """The idle seconds by what the host was doing: each of the longest
    stretches takes the name of the host operation that overlaps it most
    (the shortest of those that overlap it as much), and the seconds of
    stretches with one name are summed; the ten largest sums."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_LABELLED]
    names = [h[0] for h in host]
    starts = np.array([h[1] for h in host], dtype=np.int64)
    ends = np.array([h[2] for h in host], dtype=np.int64)
    by = {}
    for a, b in gaps:
        label = "no host operation"
        if len(names):
            over = np.minimum(ends, b) - np.maximum(starts, a)
            best = over.max()
            if best > 0:
                near = np.flatnonzero(over >= 0.999 * best)
                i = near[np.argmin((ends - starts)[near])]
                label = names[i][:100]
        by[label] = by.get(label, 0) + (b - a)
    return [[n, ns / 1e9]
            for n, ns in sorted(by.items(), key=lambda kv: -kv[1])[:10]]

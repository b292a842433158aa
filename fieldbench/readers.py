"""What the per-layer readers (``metrics/<metric>.py``) share.

A reader's ``read(run)`` gets the traced run: ``cfg`` and ``wl`` (the
cell's configuration and traffic), ``ref`` (the plain reference module),
``window_s`` (the traced window's host seconds), ``work`` (what the window
did, from the driver), ``counters`` (the program's counters over the
window), ``spans`` (the harness's host-clock spans, seconds by name) and
``trace`` (:func:`fieldbench.tracing.reduce`'s result).
"""
from __future__ import annotations

from fieldbench.yardstick import peaks, stencil

#: the port's K1 kernel, by the name the device trace gives it
K1_KERNEL = "fused_column_kernel"


def device_seconds(run: dict, match) -> tuple:
    """(seconds, count) of the traced device operations whose name
    ``match`` accepts."""
    ops = [d for n, _, d in run["trace"]["device_ops"] if match(n)]
    return sum(ops) / 1e9, len(ops)


def share_of_busy(run: dict, match):
    """Percent of the device's busy time in operations ``match`` accepts;
    None when there is none."""
    s, n = device_seconds(run, match)
    busy = run["trace"]["busy_s"]
    return 100.0 * s / busy if n and busy > 0 else None


def idle_percent(run: dict):
    t = run["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] else None


def mean(xs):
    return sum(xs) / len(xs) if xs else None


def k1_roofline(run: dict):
    """K1's share of its roofline over the window, percent: each K1 launch
    in the trace applies one body to the whole grid, whose least time is
    the larger of the grid's bytes (the padded field read once, the field
    written once) over the HBM rate and the least of the window's bodies'
    operations over the float peak; over K1's device time.  None where
    K1 did not run."""
    t, n = device_seconds(run, lambda name: K1_KERNEL in name)
    if not n:
        return None
    cfg = run["cfg"]
    shape = run["ref"].shape(cfg)
    bodies = run["ref"].bodies(cfg)
    flops = min(stencil.apply_flops(shape, bodies[b])
                for b in run["work"]["bodies"])
    least = peaks.least_seconds(flops, stencil.apply_bytes(shape, cfg["dtype"]),
                                cfg["dtype"])
    return 100.0 * n * least / t
